// Flash-attention backward for Hopper (sm_90a), with a plain C interface
// (built by mrisr_torch/_build.py, loaded with ctypes by
// mrisr_torch/ops/flash_attention.py).
//
// Replaces the TPU kernels mrisr_tpu/ops/flash_attention.py::
// _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel, launched by _flash_backward.
// With lse the forward's row logsumexp and delta = rowsum(dO * O) (computed by
// the caller, as in the reference):
//   P  = exp(scale * Q K^T - lse)          [N, M], recomputed, never stored
//   dP = dO V^T
//   dS = P * (dP - delta)
//   dQ = scale * dS K        (kernel 1, summed over K/V tiles)
//   dV = P^T dO              (kernel 2, summed over Q tiles)
//   dK = scale * dS^T Q      (kernel 2)
// Sums are fp32; dQ, dK, dV are written once, in the input dtype.
//
// What bounds them on an H100 SXM (989 TFLOP/s bf16 dense, 67 TFLOP/s fp32,
// 3.35 TB/s), at the heaviest call of a training step -- the cross-attention
// at the 128^2 skip: B=8, N=M=16384, D=32.  The dQ kernel does three products
// (6 B N M D = 0.41 TFLOP: 0.42 ms bf16, 6.2 ms fp32), the dK/dV kernel four
// (8 B N M D = 0.55 TFLOP: 0.56 ms bf16, 8.2 ms fp32); each recomputes
// B N M = 2.1 G exponentials (about 0.58 ms at the 16 per clock per SM of the
// special-function units), which at D=32 is the higher floor in bf16.  Bytes
// are ~50 MB a kernel (15 us).
//
// The TPU kernels carried their accumulators in VMEM scratch across a
// sequential grid axis.  Hopper blocks run in no order, so the reduction loop
// runs inside the block: the dQ kernel owns Q rows and loops over K/V tiles,
// the dK/dV kernel owns K/V rows and loops over Q tiles.  No atomics: each
// block writes only the rows it owns, so two calls on the same inputs give
// bitwise-equal results.
//
// bf16 design (FlashAttention-3's shape, in raw PTX: hopper.cuh, the forward's
// building blocks).  Choices marked (sweep) were timed against the
// alternative named, in turns on one H100, by
// mrisr_torch/tools/flash_bwd_sweep.py (numbers in PERF.md).
//   * One CTA per (batch, 128 owned rows): a producer warpgroup (setmaxnreg
//     24) and two consumer warpgroups of 64 owned rows each (240 registers a
//     thread).  The producer's first thread loads the owned tiles once and
//     streams the walked-over tiles through a ring of shared-memory stages
//     with TMA (3-D tensor maps [B, rows, D], zero fill past the last row per
//     batch), each stage with a full and an empty mbarrier.  Rows are 64
//     bytes at D=32 (64B swizzle), 128 at D=64 (128B), two 64-column boxes at
//     D=128; every tile base is 1024-byte aligned.
//   * dK/dV (B2b) owns K and V and walks Q, dO in tiles of BQ=64 queries (32
//     at D=128).  Per tile a consumer computes the transposed scores
//     S^T = K Q^T and dP^T = V dO^T with wgmma m64n64k16 (both operands
//     K-major: K and V act as the forward's Q, Q and dO as its K), then P^T
//     and dS^T in the accumulators, packs both to bf16 A fragments (the
//     accumulator and A-fragment layouts line up), and issues dV += P^T dO
//     and dK += dS^T Q with the RS form, where dO and Q are MN-major B
//     operands read with wgmma's transpose bit: the same shared-memory tiles
//     serve both products, no second copy.  lse*log2(e) and delta of a
//     stage's queries are copied beside the stage by the producer's first
//     warp with plain loads (a [B, N] fp32 row is no TMA row for ragged N:
//     its stride N*4 bytes need not be a multiple of 16), bounds-checked:
//     queries past N get lse = +inf, so P = 0.
//   * dQ (B2a) has the forward's shape: it owns Q and dO (loaded once) and
//     walks K/V tiles of BK=128 keys (64 at D=128) through the forward's
//     ring.  Per tile a consumer computes S = Q K^T and dP = dO V^T (wgmma
//     m64n128k16 SS, the forward's S descriptors), dS = P (dP - delta) in
//     the accumulators, and issues dQ += dS K with the RS form, K read
//     MN-major from the same stage (the forward's V descriptor).  lse and
//     delta of the thread's two rows live in registers.  Keys past M (zero
//     rows of the last tile) get dS = 0 explicitly, on the last tile and
//     only when M % BK != 0: a zero key has score 0, and exp2(-lse)
//     overflows where every real score is very negative.
//   * Tiles at D=128: S and dP take BK/2 registers a thread each and dK, dV
//     (or dQ) D/2 each; with BK=128 in dQ or BQ=64 in dK/dV ptxas runs out
//     of registers and serializes the wgmmas (C7512, with spills): 2.0-2.2x
//     and 1.7-1.9x slower than BK=64 and BQ=32 (sweep).  At D=32 and 64,
//     BK=64 in dQ was 2-27 % slower and BQ=128 in dK/dV (C7512) 13-29 %
//     slower at D=32 (sweep).
//   * Pipeline, per consumer (the forward's one-buffer order): issue the
//     score pair of tile t, then the second-stage products of tile t-1; the
//     exponentials of tile t run while those products do, and P/dS of tile t
//     are packed once they have retired.  A stage is released when its last
//     product has retired (dQ: V after the score pair, K after dQ).  dQ's
//     last tile takes its own step, so the loop carries no key mask (as
//     selects on every tile it cost 137 of 580 instructions a loop; 1-13 %
//     slower at D=64, 1-6 % at D=128; sweep).  The two consumers take turns
//     issuing on named barriers: dQ 4-24 % faster at every D, dK/dV 13-27 %
//     at D=128 and within noise (-4 to 9 %) at D=32 and 64 (sweep).
//   * Tried and not kept (PERF.md has the numbers): in dK/dV, the score pair
//     of tile t+1 issued ahead of the exponentials of tile t into a second
//     pair of score buffers (within noise at D=32, no room at D=64), and
//     three consumer warpgroups at D=32; the bf16 packing of P and dS on the
//     FP32 pipe instead of by cvt (nowhere faster, up to 30 % slower).
//   * wgmma operands are pinned with fence_regs around each batch and every
//     wgmma group is issued on a path fixed at compile time (ptxas serializes
//     the pipeline otherwise: notes C7511/C7513/C7515).
//   * Numerics: every product takes bf16 operands (dO, V as given; P and dS
//     rounded to bf16, 2^-9 relative) with fp32 accumulation.  The reference
//     casts dO and V to fp32 for dP and keeps P^T in fp32 for dV; the effect
//     is a relative error of a few 1e-3 in each gradient, the order of the
//     bf16 rounding of the outputs themselves.  P is recomputed against the
//     lse of this package's forward kernel, with scale * log2(e) folded into
//     one exp2.  In bf16 that forward sums bf16-rounded p into its
//     denominator, so sum_j P_ij here is 1 only to ~2^-9: the reference has
//     the same mismatch and accepts it at bf16 tolerance.
//   * fp32: plain FMA (no TF32), 64 owned rows a block, 4 threads per owned
//     row, each holding a quarter of D; the tile walked over has 32 rows in
//     shared memory and the inner loop stops at its last valid row.  In fp32
//     the pair with the forward is consistent to rounding.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBlockRows = 64;  // rows owned by a block of the fp32 kernels

// Tile table of the bf16 dQ kernel (B2a), per head dimension D.
template <int D>
struct DqTiles : SwizzledRows<D> {
  static constexpr int kConsumers = 2;               // consumer warpgroups, 64 Q rows each
  static constexpr int kRowsQ = 64 * kConsumers;     // Q (dO, dQ) rows per CTA
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  // BK: keys per K/V tile.  S and dP take BK/2 registers a thread each, dQ
  // D/2: at D=128 BK=128 leaves ptxas too few and it serializes the wgmmas.
  static constexpr int kKeys = D == 128 ? 64 : 128;
  static constexpr int kStages = D == 32 ? 4 : (kKeys * D < 128 * 128 ? 3 : 2);
  // The two consumer warpgroups take turns issuing on named barriers.
  static constexpr bool kPingPong = true;
  static constexpr int kQBytes = kRowsQ * D * 2;     // Q, and dO
  static constexpr int kTileBytes = kKeys * D * 2;   // one K (or V) stage
  static constexpr int kBarBytes = 8 + KvRing<kStages>::kBarBytes;
  // Shared memory: Q, dO, K stages, V stages, barriers, plus slack to align the base to 1024.
  static constexpr int kSmemBytes = 2 * kQBytes + 2 * kStages * kTileBytes + kBarBytes + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory per block");
};

// Tile table of the bf16 dK/dV kernel (B2b), per head dimension D.
template <int D>
struct DkvTiles : SwizzledRows<D> {
  static constexpr int kConsumers = 2;               // consumer warpgroups, 64 K/V rows each
  static constexpr int kRowsKV = 64 * kConsumers;    // K/V (dK/dV) rows per CTA
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // Registers a thread after setmaxnreg: the producer gives up what the
  // consumers take, from the 65536 / kThreads each starts with.
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  // BQ: queries per Q/dO tile.  S^T and dP^T take BQ/2 registers a thread
  // each, dK and dV D/2 each: at D=128 BQ=64 leaves ptxas too few.
  static constexpr int kQueries = D == 128 ? 32 : 64;
  static constexpr int kStages = 4;
  // The two consumer warpgroups take turns issuing on named barriers.
  static constexpr bool kPingPong = true;
  static constexpr int kKVBytes = kRowsKV * D * 2;   // K, and V
  static constexpr int kTileBytes = kQueries * D * 2;  // one Q (or dO) stage
  static constexpr int kVecBytes = 2 * kQueries * 4;   // one stage's lse * log2(e) and delta
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  // Shared memory: K, V, Q stages, dO stages, vectors, barriers, plus slack to align the base to 1024.
  static constexpr int kSmemBytes =
      2 * kKVBytes + 2 * kStages * kTileBytes + kStages * kVecBytes + kBarBytes + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory per block");
};

template <int D>
__global__ void __launch_bounds__(DqTiles<D>::kThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int N, int M, float scale_log2, float scale) {
  using T = DqTiles<D>;
  constexpr int BK = T::kKeys;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte aligned bases.
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + T::kQBytes;
  const uint32_t k_s = do_s + T::kQBytes;
  const uint32_t v_s = k_s + S * T::kTileBytes;
  const uint32_t q_full = v_s + S * T::kTileBytes;  // then the K/V ring's barriers
  const KvRing<S> ring{q_full};

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * T::kRowsQ;
  const int n_tiles = (M + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    ring.init(4 * T::kConsumers);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    setmaxnreg_dec<T::kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tdo);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(q_full, 2 * T::kQBytes);
#pragma unroll
      for (int x = 0; x < T::kBoxes; ++x) {
        tma_load_3d(q_s + x * T::kRowsQ * T::kRowBytes, &tq, q_full, x * T::kBox, q0, b);
        tma_load_3d(do_s + x * T::kRowsQ * T::kRowBytes, &tdo, q_full, x * T::kBox, q0, b);
      }
      ring.template produce<T>(k_s, v_s, &tk, &tv, n_tiles, b);
    }
  } else {
    // ---- consumer warpgroups: 64 Q rows each ----
    setmaxnreg_inc<T::kConsumerRegs>();
    // Warp-uniform by construction (a shuffle from lane 0), so descriptors stay in uniform registers.
    const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0) - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    // This thread's rows (accumulator rows g and g+8 of its warp) and their lse * log2(e) and delta.
    const int row_a = q0 + wg * 64 + warp * 16 + g;
    const int row_b = row_a + 8;
    const float* lse_b = lse + (size_t)b * N;
    const float* delta_b = delta + (size_t)b * N;
    const float l2a = row_a < N ? lse_b[row_a] * kLog2e : 0.f;
    const float l2b = row_b < N ? lse_b[row_b] * kLog2e : 0.f;
    const float dla = row_a < N ? delta_b[row_a] : 0.f;
    const float dlb = row_b < N ? delta_b[row_b] : 0.f;
    const bool ragged = M % BK != 0;
    const int last_valid = M - (n_tiles - 1) * BK;

    float s[BK / 2], dp[BK / 2], dq_acc[D / 2];
    uint32_t ds[BK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    // S = Q K^T and dP = dO V^T, all operands K-major (the forward's S).
    auto sdp_issue = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<BK>(s, T::k_major(q_s, T::kRowsQ, wg * 64, kk),
                     T::k_major(k_s + st * T::kTileBytes, BK, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<BK>(dp, T::k_major(do_s, T::kRowsQ, wg * 64, kk),
                     T::k_major(v_s + st * T::kTileBytes, BK, 0, kk), kk > 0);
      }
    };
    // dQ += dS K: K read MN-major from the same stage (the forward's V).
    auto dq_issue = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_rs<D>(dq_acc, ds[kk], T::mn_major(k_s + st * T::kTileBytes, BK, kk));
      }
    };
    // dS = P (dP - delta) in place of dP, P = exp2(S scale log2(e) - lse log2(e)).
    // With `mask`, keys >= last_valid (zero rows past M) get dS = 0.
    auto grads = [&](bool mask) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        dp[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -l2a)) * (dp[4 * j] - dla);
        dp[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -l2a)) * (dp[4 * j + 1] - dla);
        dp[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -l2b)) * (dp[4 * j + 2] - dlb);
        dp[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -l2b)) * (dp[4 * j + 3] - dlb);
      }
      if (mask) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j * 8 + t4 * 2 + (e & 1) >= last_valid) dp[4 * j + e] = 0.f;
          }
        }
      }
    };
    auto stage = [](int t) { return t % S; };
    auto parity = [](int t) { return (uint32_t)((t / S) & 1); };

    mbar_wait(q_full, 0);
    // Tile 0.
    mbar_wait(ring.k_full(0), 0);
    mbar_wait(ring.v_full(0), 0);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    sdp_issue(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (lane == 0) mbar_arrive(ring.v_empty(0));
    grads(ragged && n_tiles == 1);
    to_a_frags<BK>(dp, ds);

    // Tile t: issue S(t) and dP(t), then dQ += dS(t-1) K(t-1); dS(t) is
    // computed while that product runs and packed once it has retired.
    // `mask` is a literal false in the loop, so the loop carries no masking
    // code; the last tile takes its own step.
    auto step = [&](int t, bool mask) {
      mbar_wait(ring.k_full(stage(t)), parity(t));
      mbar_wait(ring.v_full(stage(t)), parity(t));
      // Turns: warpgroup 0 issues tile t's products, then warpgroup 1 (barrier
      // 1 + wg is this warpgroup's turn, signalled by the other one).
      if (T::kPingPong && !(wg == 0 && t == 1)) named_bar_sync(1 + wg, 256);
      fence_regs(s);
      fence_regs(dp);
      fence_regs(dq_acc);
      fence_regs(ds);
      wgmma_fence();
      sdp_issue(stage(t));
      wgmma_commit();
      dq_issue(stage(t - 1));
      wgmma_commit();
      if (T::kPingPong && !(wg == 1 && t == n_tiles - 1)) named_bar_arrive(2 - wg, 256);
      wgmma_wait<1>();  // S(t) and dP(t) are ready; dQ of tile t - 1 may still run
      fence_regs(s);
      fence_regs(dp);
      if (lane == 0) mbar_arrive(ring.v_empty(stage(t)));
      grads(mask);
      wgmma_wait<0>();
      fence_regs(dq_acc);
      fence_regs(ds);
      if (lane == 0) mbar_arrive(ring.k_empty(stage(t - 1)));
      to_a_frags<BK>(dp, ds);
    };
    for (int t = 1; t < n_tiles - 1; ++t) step(t, false);
    if (n_tiles > 1) step(n_tiles - 1, ragged);
    fence_regs(dq_acc);
    fence_regs(ds);
    wgmma_fence();
    dq_issue(stage(n_tiles - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);

    store_rows_bf16<D>(dq_acc, dq + (size_t)b * N * D, row_a, N, scale, scale, t4);
  }
}

template <int D>
__global__ void __launch_bounds__(DkvTiles<D>::kThreads, 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N, int M,
                              float scale_log2, float scale) {
  using T = DkvTiles<D>;
  constexpr int BQ = T::kQueries;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte aligned bases.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + T::kKVBytes;
  const uint32_t q_s = v_s + T::kKVBytes;          // Q stages
  const uint32_t do_s = q_s + S * T::kTileBytes;   // dO stages
  const uint32_t vec_s = do_s + S * T::kTileBytes;  // per stage: lse * log2(e) [BQ], then delta [BQ]
  const uint32_t bar = vec_s + S * T::kVecBytes;   // kv_full, then full[S], empty[S]
  float* vecs = reinterpret_cast<float*>(smem_raw + (vec_s - raw));
  const uint32_t kv_full = bar;
  auto full = [&](int st) { return bar + 8 * (1 + st); };
  auto empty = [&](int st) { return bar + 8 * (1 + S + st); };

  const int b = blockIdx.y;
  const int k0 = blockIdx.x * T::kRowsKV;
  const int n_tiles = (N + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 32);                  // the 32 lanes of the producer's first warp
      mbar_init(empty(st), 4 * T::kConsumers);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: its first warp fills the ring ----
    setmaxnreg_dec<T::kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        tma_prefetch_map(&tk);
        tma_prefetch_map(&tv);
        tma_prefetch_map(&tq);
        tma_prefetch_map(&tdo);
        mbar_arrive_expect_tx(kv_full, 2 * T::kKVBytes);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x) {
          tma_load_3d(k_s + x * T::kRowsKV * T::kRowBytes, &tk, kv_full, x * T::kBox, k0, b);
          tma_load_3d(v_s + x * T::kRowsKV * T::kRowBytes, &tv, kv_full, x * T::kBox, k0, b);
        }
      }
      // Lane 0 issues the TMA loads of Q and dO; every lane copies its share
      // of the stage's lse * log2(e) and delta (read before the stage is free)
      // and then arrives.
      const float* lse_b = lse + (size_t)b * N;
      const float* delta_b = delta + (size_t)b * N;
      int st = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        float l2[BQ / 32], dl[BQ / 32];
#pragma unroll
        for (int i = 0; i < BQ / 32; ++i) {
          const int row = t * BQ + 32 * i + lane;
          l2[i] = row < N ? lse_b[row] * kLog2e : INFINITY;  // queries past N: P = 0
          dl[i] = row < N ? delta_b[row] : 0.f;
        }
        mbar_wait(empty(st), phase ^ 1);
        float* vec = vecs + st * 2 * BQ;
#pragma unroll
        for (int i = 0; i < BQ / 32; ++i) {
          vec[32 * i + lane] = l2[i];
          vec[BQ + 32 * i + lane] = dl[i];
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full(st), 2 * T::kTileBytes);
#pragma unroll
          for (int x = 0; x < T::kBoxes; ++x) {
            tma_load_3d(q_s + st * T::kTileBytes + x * BQ * T::kRowBytes, &tq, full(st), x * T::kBox, t * BQ, b);
            tma_load_3d(do_s + st * T::kTileBytes + x * BQ * T::kRowBytes, &tdo, full(st), x * T::kBox, t * BQ,
                        b);
          }
        } else {
          mbar_arrive(full(st));
        }
        if (++st == S) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 K/V rows each ----
    setmaxnreg_inc<T::kConsumerRegs>();
    const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0) - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;

    // Transposed tiles: rows are this warpgroup's keys, columns the BQ queries.
    float st_acc[BQ / 2], dpt[BQ / 2], dk_acc[D / 2], dv_acc[D / 2];
    uint32_t pt[BQ / 16][4], dst[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }

    // S^T = K Q^T and dP^T = V dO^T, all operands K-major: K and V as the
    // forward's Q, the Q and dO stages as its K.
    auto sdp_issue = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<BQ>(st_acc, T::k_major(k_s, T::kRowsKV, wg * 64, kk),
                     T::k_major(q_s + st * T::kTileBytes, BQ, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<BQ>(dpt, T::k_major(v_s, T::kRowsKV, wg * 64, kk),
                     T::k_major(do_s + st * T::kTileBytes, BQ, 0, kk), kk > 0);
      }
    };
    // dV += P^T dO and dK += dS^T Q: the same dO and Q stages, now MN-major
    // B operands read with the transpose bit.
    auto dkv_issue = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wgmma_rs<D>(dv_acc, pt[kk], T::mn_major(do_s + st * T::kTileBytes, BQ, kk));
        wgmma_rs<D>(dk_acc, dst[kk], T::mn_major(q_s + st * T::kTileBytes, BQ, kk));
      }
    };
    // P^T in place of S^T, dS^T in place of dP^T; a column is a query, whose
    // lse * log2(e) and delta the producer put beside the stage.
    auto grads = [&](int st) {
      const float* vec = vecs + st * 2 * BQ;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(vec + 8 * j + 2 * t4);
        const float2 dl = *reinterpret_cast<const float2*>(vec + BQ + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(st_acc[4 * j + e], scale_log2, (e & 1) ? -l2.y : -l2.x));
          st_acc[4 * j + e] = p;
          dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x));
        }
      }
    };
    auto fence_second = [&]() {  // the operands of dkv_issue
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(pt);
      fence_regs(dst);
    };
    auto stage = [](int t) { return t % S; };
    auto parity = [](int t) { return (uint32_t)((t / S) & 1); };

    mbar_wait(kv_full, 0);
    // Tile 0.
    mbar_wait(full(0), 0);
    fence_regs(st_acc);
    fence_regs(dpt);
    wgmma_fence();
    sdp_issue(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st_acc);
    fence_regs(dpt);
    grads(0);
    to_a_frags<BQ>(st_acc, pt);
    to_a_frags<BQ>(dpt, dst);

    // Tile t: issue S^T(t) and dP^T(t), then dV and dK of tile t - 1; P^T(t)
    // and dS^T(t) are computed while those run and packed once they have retired.
    for (int t = 1; t < n_tiles; ++t) {
      mbar_wait(full(stage(t)), parity(t));
      // Turns: warpgroup 0 issues tile t's products, then warpgroup 1 (barrier
      // 1 + wg is this warpgroup's turn, signalled by the other one).
      if (T::kPingPong && !(wg == 0 && t == 1)) named_bar_sync(1 + wg, 256);
      fence_regs(st_acc);
      fence_regs(dpt);
      fence_second();
      wgmma_fence();
      sdp_issue(stage(t));
      wgmma_commit();
      dkv_issue(stage(t - 1));
      wgmma_commit();
      if (T::kPingPong && !(wg == 1 && t == n_tiles - 1)) named_bar_arrive(2 - wg, 256);
      wgmma_wait<1>();  // S^T(t) and dP^T(t) are ready; dV, dK of tile t - 1 may still run
      fence_regs(st_acc);
      fence_regs(dpt);
      grads(stage(t));
      wgmma_wait<0>();
      fence_second();
      if (lane == 0) mbar_arrive(empty(stage(t - 1)));
      to_a_frags<BQ>(st_acc, pt);
      to_a_frags<BQ>(dpt, dst);
    }
    fence_second();
    wgmma_fence();
    dkv_issue(stage(n_tiles - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);

    const int row_a = k0 + wg * 64 + warp * 16 + g;
    store_rows_bf16<D>(dk_acc, dk + (size_t)b * M * D, row_a, M, scale, scale, t4);
    store_rows_bf16<D>(dv_acc, dv + (size_t)b * M * D, row_a, M, 1.f, 1.f, t4);
  }
}

// fp32 kernels: thread `part` of a row owns the float4s j*4 + part of it, so
// the 4 threads of a row read 64 consecutive bytes of a shared-memory row.
constexpr int kTileF32 = 32;  // rows of the tile walked over

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& y, float a, float4 x) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

__device__ __forceinline__ float sum_over_row_threads(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stage rows [row0, row0 + kTileF32) of two [rows_total, D] fp32 matrices,
// zero-filling rows past rows_total.
template <int D>
__device__ __forceinline__ void load_tiles_f32(float4* dst_a, float4* dst_b, const float4* src_a,
                                               const float4* src_b, int row0, int rows_total) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = threadIdx.x; c < kTileF32 * (D / 4); c += 256) {
    const bool in = row0 + c / (D / 4) < rows_total;
    dst_a[c] = in ? src_a[(size_t)row0 * (D / 4) + c] : zero;
    dst_b[c] = in ? src_b[(size_t)row0 * (D / 4) + c] : zero;
  }
}

template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, int N, int M, float scale_log2, float scale) {
  constexpr int V4 = D / 16;  // float4s of D owned by each of the 4 threads of a row
  extern __shared__ float4 smem_f4[];
  float4* Ks = smem_f4;
  float4* Vs = smem_f4 + kTileF32 * (D / 4);

  const int b = blockIdx.y;
  const int row = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const int qrow = blockIdx.x * kBlockRows + row;
  const bool valid = qrow < N;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 qv[V4], dov[V4], acc[V4];
  const float4* qr = reinterpret_cast<const float4*>(q + ((size_t)b * N + qrow) * D);
  const float4* dor = reinterpret_cast<const float4*>(dout + ((size_t)b * N + qrow) * D);
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    qv[j] = valid ? qr[j * 4 + part] : zero;
    dov[j] = valid ? dor[j * 4 + part] : zero;
    acc[j] = zero;
  }
  const float lse2 = valid ? lse[(size_t)b * N + qrow] * kLog2e : 0.f;
  const float dl = valid ? delta[(size_t)b * N + qrow] : 0.f;
  const float4* kb = reinterpret_cast<const float4*>(k + (size_t)b * M * D);
  const float4* vb = reinterpret_cast<const float4*>(v + (size_t)b * M * D);

  const int n_tiles = (M + kTileF32 - 1) / kTileF32;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTileF32;
    __syncthreads();
    load_tiles_f32<D>(Ks, Vs, kb, vb, k0, M);
    __syncthreads();
    const int n_keys = min(kTileF32, M - k0);
    for (int c = 0; c < n_keys; ++c) {
      const float4* kr = Ks + c * (D / 4);
      const float4* vr = Vs + c * (D / 4);
      float4 kk[V4];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < V4; ++j) {
        kk[j] = kr[j * 4 + part];
        s = dot4(qv[j], kk[j], s);
        dp = dot4(dov[j], vr[j * 4 + part], dp);
      }
      s = sum_over_row_threads(s);
      dp = sum_over_row_threads(dp);
      const float ds = exp2f(s * scale_log2 - lse2) * (dp - dl);
#pragma unroll
      for (int j = 0; j < V4; ++j) axpy4(acc[j], ds, kk[j]);
    }
  }

  if (valid) {
    float4* orow = reinterpret_cast<float4*>(dq + ((size_t)b * N + qrow) * D);
#pragma unroll
    for (int j = 0; j < V4; ++j) {
      orow[j * 4 + part] =
          make_float4(acc[j].x * scale, acc[j].y * scale, acc[j].z * scale, acc[j].w * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, int N, int M,
                             float scale_log2, float scale) {
  constexpr int V4 = D / 16;
  extern __shared__ float4 smem_f4[];
  float4* Qs = smem_f4;
  float4* dOs = smem_f4 + kTileF32 * (D / 4);
  float* lse2s = reinterpret_cast<float*>(dOs + kTileF32 * (D / 4));
  float* dls = lse2s + kTileF32;

  const int b = blockIdx.y;
  const int row = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const int krow = blockIdx.x * kBlockRows + row;
  const bool valid = krow < M;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 kv[V4], vv[V4], dka[V4], dva[V4];
  const float4* kr = reinterpret_cast<const float4*>(k + ((size_t)b * M + krow) * D);
  const float4* vr = reinterpret_cast<const float4*>(v + ((size_t)b * M + krow) * D);
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    kv[j] = valid ? kr[j * 4 + part] : zero;
    vv[j] = valid ? vr[j * 4 + part] : zero;
    dka[j] = zero;
    dva[j] = zero;
  }
  const float4* qb = reinterpret_cast<const float4*>(q + (size_t)b * N * D);
  const float4* dob = reinterpret_cast<const float4*>(dout + (size_t)b * N * D);

  const int n_tiles = (N + kTileF32 - 1) / kTileF32;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kTileF32;
    __syncthreads();
    load_tiles_f32<D>(Qs, dOs, qb, dob, q0, N);
    if (threadIdx.x < kTileF32) {
      const int r = q0 + threadIdx.x;
      lse2s[threadIdx.x] = r < N ? lse[(size_t)b * N + r] * kLog2e : 0.f;
      dls[threadIdx.x] = r < N ? delta[(size_t)b * N + r] : 0.f;
    }
    __syncthreads();
    const int n_rows = min(kTileF32, N - q0);
    for (int c = 0; c < n_rows; ++c) {
      const float4* qr = Qs + c * (D / 4);
      const float4* dor = dOs + c * (D / 4);
      float4 qq[V4], dd[V4];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < V4; ++j) {
        qq[j] = qr[j * 4 + part];
        dd[j] = dor[j * 4 + part];
        s = dot4(kv[j], qq[j], s);
        dp = dot4(vv[j], dd[j], dp);
      }
      s = sum_over_row_threads(s);
      dp = sum_over_row_threads(dp);
      const float p = exp2f(s * scale_log2 - lse2s[c]);
      const float ds = p * (dp - dls[c]);
#pragma unroll
      for (int j = 0; j < V4; ++j) {
        axpy4(dva[j], p, dd[j]);
        axpy4(dka[j], ds, qq[j]);
      }
    }
  }

  if (valid) {
    float4* dkr = reinterpret_cast<float4*>(dk + ((size_t)b * M + krow) * D);
    float4* dvr = reinterpret_cast<float4*>(dv + ((size_t)b * M + krow) * D);
#pragma unroll
    for (int j = 0; j < V4; ++j) {
      dkr[j * 4 + part] =
          make_float4(dka[j].x * scale, dka[j].y * scale, dka[j].z * scale, dka[j].w * scale);
      dvr[j * 4 + part] = dva[j];
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, N, M;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const Args& a, void* dq, bool bf16) {
  const float sl2 = a.scale * kLog2e;
  if (bf16) {
    using T = DqTiles<D>;
    CUtensorMap tq, tk, tv, tdo;
    if (!encode_map(&tq, a.q, a.B, a.N, D, T::kBox, T::kRowsQ) ||
        !encode_map(&tdo, a.dout, a.B, a.N, D, T::kBox, T::kRowsQ) ||
        !encode_map(&tk, a.k, a.B, a.M, D, T::kBox, T::kKeys) ||
        !encode_map(&tv, a.v, a.B, a.M, D, T::kBox, T::kKeys)) {
      return cudaErrorInvalidValue;
    }
    const cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<D>, T::kSmemBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.N + T::kRowsQ - 1) / T::kRowsQ, a.B);
    flash_bwd_dq_bf16_kernel<D><<<grid, T::kThreads, T::kSmemBytes, a.stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(dq), a.N, a.M, sl2, a.scale);
  } else {
    const size_t smem = (size_t)2 * kTileF32 * D * sizeof(float);
    const cudaError_t err = allow_smem(flash_bwd_dq_f32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    using T = float;
    const dim3 grid((a.N + kBlockRows - 1) / kBlockRows, a.B);
    flash_bwd_dq_f32_kernel<D><<<grid, 256, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dq), a.N, a.M, sl2, a.scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, bool bf16) {
  const float sl2 = a.scale * kLog2e;
  if (bf16) {
    using T = DkvTiles<D>;
    CUtensorMap tq, tk, tv, tdo;
    if (!encode_map(&tq, a.q, a.B, a.N, D, T::kBox, T::kQueries) ||
        !encode_map(&tdo, a.dout, a.B, a.N, D, T::kBox, T::kQueries) ||
        !encode_map(&tk, a.k, a.B, a.M, D, T::kBox, T::kRowsKV) ||
        !encode_map(&tv, a.v, a.B, a.M, D, T::kBox, T::kRowsKV)) {
      return cudaErrorInvalidValue;
    }
    const cudaError_t err = allow_smem(flash_bwd_dkv_bf16_kernel<D>, T::kSmemBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.M + T::kRowsKV - 1) / T::kRowsKV, a.B);
    using E = __nv_bfloat16;
    flash_bwd_dkv_bf16_kernel<D><<<grid, T::kThreads, T::kSmemBytes, a.stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, static_cast<E*>(dk), static_cast<E*>(dv), a.N, a.M, sl2, a.scale);
  } else {
    const size_t smem = (size_t)2 * kTileF32 * D * sizeof(float) + 2 * kTileF32 * sizeof(float);
    const cudaError_t err = allow_smem(flash_bwd_dkv_f32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    using T = float;
    const dim3 grid((a.M + kBlockRows - 1) / kBlockRows, a.B);
    flash_bwd_dkv_f32_kernel<D><<<grid, 256, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dk), static_cast<T*>(dv),
        a.N, a.M, sl2, a.scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, dout, dq [B,N,D]; k, v, dk, dv [B,M,D] (all contiguous, same dtype, 16-byte
// aligned: the bf16 kernels read q, k, v, dout through TMA tensor maps);
// lse, delta [B,N] fp32.  is_bf16 selects bf16 (1) or fp32 (0); D is 32, 64
// or 128.  Each returns the cudaError_t of its launch (0 on success).
extern "C" int mrisr_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, int B, int N, int M, int D, int is_bf16,
                                       float scale, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               B, N, M, scale, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return (int)launch_dq<32>(a, dq, is_bf16 != 0);
    case 64: return (int)launch_dq<64>(a, dq, is_bf16 != 0);
    case 128: return (int)launch_dq<128>(a, dq, is_bf16 != 0);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int mrisr_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dk, void* dv, int B, int N, int M, int D,
                                        int is_bf16, float scale, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               B, N, M, scale, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return (int)launch_dkv<32>(a, dk, dv, is_bf16 != 0);
    case 64: return (int)launch_dkv<64>(a, dk, dv, is_bf16 != 0);
    case 128: return (int)launch_dkv<128>(a, dk, dv, is_bf16 != 0);
  }
  return (int)cudaErrorInvalidValue;
}
