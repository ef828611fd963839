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
// What bounds them on an H100 SXM (989 TFLOP/s bf16 dense, 495 TF32, 67 fp32
// outside the tensor cores, 3.35 TB/s), at the heaviest call of a training
// step -- the cross-attention at the 128^2 skip: B=8, N=M=16384, D=32.  The dQ
// kernel does three products (6 B N M D = 0.41 TFLOP: 0.42 ms bf16; 2.50 ms
// fp32 as 3xTF32, three tf32 passes a product, where FMA would take 6.2 ms),
// the dK/dV kernel four (8 B N M D = 0.55 TFLOP: 0.56 ms bf16, 3.33 ms
// 3xTF32, 8.2 ms FMA); each recomputes B N M = 2.1 G exponentials (about 0.58
// ms at the 16 per clock per SM of the special-function units), which at D=32
// is the higher floor in bf16 and well under the tensor-core floor in fp32.
// Bytes are ~50 MB a kernel in bf16 (15 us), about four times that in fp32.
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
//
// fp32 design: 3xTF32 on the tensor cores, in the bf16 kernels' shape (the
// producer, two consumers taking turns, the pipeline order, dQ's last tile in
// its own step, no atomics).
//   * Each operand x is split into hi = x rounded to tf32 and lo = x - hi
//     rounded (to nearest, ties away: cvt.rna), and a product takes lo hi +
//     hi lo + hi hi (lo lo dropped): ~2^-21 relative a term.  The tensor cores
//     drop the 13 low bits of a raw fp32 operand (tools/tf32_probe.py), so
//     both parts reach them already rounded; a truncated split biased every
//     product toward zero.  They also truncate as they accumulate: over 16384
//     keys that biased dQ, dK and dV by 1.2e-4 (the fp32 limit is 1e-4), so
//     each tile's second-stage product goes to a fresh accumulator and is
//     added to the running sum in fp32 registers (add_to).
//   * tf32 wgmma takes only K-major operands (there is no transpose bit for
//     32-bit types).  The score products are K-major as they are; dQ sums
//     over keys and dK, dV over queries, so flash_attention_bwd writes K, Q
//     and dO transposed ([B, D, rows padded to kTransposePad], zeros past the
//     end) with each group of 8 rows permuted: a thread's accumulator columns
//     2t, 2t+1 are its A fragment's k t, t+4 (to_tf32_frags), and B's rows
//     are put in that order, so P and dS go from accumulators to A fragments
//     with no shuffle.  The parts (hi and lo of Q, K, V, dO and of the three
//     copies) are plain PyTorch (tf32_parts), made once a backward; their
//     device time is part of the pair's.
//   * Shared memory holds every operand twice (hi, lo) and the walked one
//     twice more, transposed: dQ keeps Q and dO of its rows and walks stages
//     of K, K^T | V; dK/dV keeps K and V and walks stages of Q, dO, Q^T, dO^T
//     with lse and delta beside each.  So tiles are smaller than in bf16, and
//     the choices differ by D (sweep, ms at 8x16384^2x32 / 8x4096^2x64; PERF.md):
//     dQ takes BK = 64 keys and two consumers at D=32 (32 keys: 25 % slower),
//     32 keys and one consumer of 64 rows in 3 stages at D=64 (two consumers
//     in 2 stages: 17-20 % slower), and at D=128, where Q and dO of 64 rows
//     take 128 KB, one consumer and 16 keys in 2 stages.  dK/dV takes BQ = 32
//     queries at D=32 (4 stages; 64 queries serialize the wgmmas, C7512) and
//     16 at D=64 (3 stages; one consumer with 32 queries: 35 % slower).  At
//     D=128 dK/dV has room for 64 K/V rows and one stage: both consumers take
//     the same rows, each half of dK's and dV's columns (the two accumulators
//     and their per-tile parts do not fit one thread's registers), and run
//     each tile's products one after the other.  Turns between the consumers
//     pay 7-11 % in dQ at D=32 and 1-8 % in dK/dV.
//   * Where the time goes (sweep ablations): at 8x16384^2x32 dQ takes
//     3.57-3.90 ms against a 3xTF32 bound of 2.50, 1.0 ms without its dQ
//     product and 1.75 ms with one tf32 pass; without exponentials it is
//     within noise.  The second-stage products (m64nDk8 with D = 32, three
//     passes a k-step) set the time, not the exp unit.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

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

// ---- fp32: 3xTF32 on the tensor cores ---------------------------------------

// The operands of the fp32 kernels, made by flash_attention.py::tf32_parts (in
// this order in the `parts` argument): the high and low tf32 parts of Q, K,
// V, dO (hi = x rounded to tf32, lo = x - hi rounded), and Q, dO (for dK/dV)
// and K (for dQ) transposed to [B, D, rows padded to kTransposePad], high and
// low, each group of 8 rows permuted as to_tf32_frags needs.
enum Part { kQHi, kKHi, kVHi, kDoHi, kQLo, kKLo, kVLo, kDoLo, kQt, kQtLo, kDot, kDotLo, kKt, kKtLo };
constexpr int kTransposePad = 64;

// Tile table of the fp32 dQ kernel (B2a), per head dimension D.  Every
// operand is in shared memory twice (high and low part), and K a third and
// fourth time transposed: the owned tiles take 16 bytes a row and column.
template <int D>
struct DqF32Tiles {
  using Rows = SwizzledRows<D, 4>;  // Q, dO, K, V tiles: D columns
  // At D=64 one consumer (64 Q rows a CTA, 3 stages) was 17-20 % faster than
  // two (sweep); at D=128 the owned tiles leave room for 64 rows only.
  static constexpr int kConsumers = D == 32 ? 2 : 1;
  static constexpr int kRowsQ = 64 * kConsumers;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kKeys = D == 32 ? 64 : (D == 64 ? 32 : 16);  // BK: keys per K/V tile
  using RowsT = SwizzledRows<kKeys, 4>;  // K^T tiles: BK columns
  // The loop issues tile t's scores before it releases tile t - 1: two stages at least.
  static constexpr int kStages = D == 128 ? 2 : 3;
  // The two consumer warpgroups take turns issuing on named barriers.
  static constexpr bool kPingPong = kConsumers == 2;
  static constexpr int kQBytes = kRowsQ * D * 4;      // each of Q, Q lo, dO, dO lo
  static constexpr int kTileBytes = kKeys * D * 4;    // each of K, K lo, K^T, K^T lo (a K stage), V, V lo (a V stage)
  static constexpr int kKStage = 4 * kTileBytes, kVStage = 2 * kTileBytes;
  static constexpr int kBarBytes = 8 + KvRing<kStages>::kBarBytes;
  // Shared memory: Q, Q lo, dO, dO lo, K stages, V stages, barriers, plus slack to align the base to 1024.
  static constexpr int kSmemBytes = 4 * kQBytes + kStages * (kKStage + kVStage) + kBarBytes + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory per block");
};

// Tile table of the fp32 dK/dV kernel (B2b), per head dimension D.
template <int D>
struct DkvF32Tiles {
  using Rows = SwizzledRows<D, 4>;  // K, V, Q, dO tiles: D columns
  static constexpr int kConsumers = 2;
  // At D=128 the owned tiles leave room for 64 K/V rows only, and dK, dV and
  // their per-tile parts need more registers than a thread has: both
  // consumer warpgroups take the 64 rows, each computing all of S^T and dP^T
  // and half of dK's and dV's columns.
  static constexpr bool kSplitD = D == 128;
  static constexpr int kRowsKV = kSplitD ? 64 : 64 * kConsumers;
  static constexpr int kCols = kSplitD ? D / 2 : D;   // dK, dV columns a consumer owns
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kQueries = D == 32 ? 32 : 16;  // BQ: queries per Q/dO tile
  using RowsT = SwizzledRows<kQueries, 4>;  // Q^T, dO^T tiles: BQ columns
  // At D=128 one stage is all that fits: the consumers then run each tile's
  // products one after the other (no overlap within a warpgroup).
  static constexpr int kStages = D == 32 ? 4 : (D == 64 ? 3 : 1);
  static constexpr bool kPingPong = kConsumers == 2;
  static constexpr int kKVBytes = kRowsKV * D * 4;    // each of K, K lo, V, V lo
  static constexpr int kTileBytes = kQueries * D * 4;  // each of the eight tiles of a stage
  static constexpr int kStageBytes = 8 * kTileBytes;  // Q, Q lo, dO, dO lo, Q^T, Q^T lo, dO^T, dO^T lo
  static constexpr int kVecBytes = 2 * kQueries * 4;  // one stage's lse * log2(e) and delta
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  // Shared memory: K, K lo, V, V lo, stages, vectors, barriers, plus slack to align the base to 1024.
  static constexpr int kSmemBytes = 4 * kKVBytes + kStages * (kStageBytes + kVecBytes) + kBarBytes + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory per block");
};

// The tensor maps of an fp32 kernel: the parts it reads.
struct F32Maps {
  CUtensorMap q, q_lo, dout, do_lo, k, k_lo, v, v_lo, qt, qt_lo, dot, dot_lo, kt, kt_lo;
};

template <int D>
__global__ void __launch_bounds__(DqF32Tiles<D>::kThreads, 1)
    flash_bwd_dq_f32_kernel(const __grid_constant__ F32Maps m, const float* __restrict__ lse,
                            const float* __restrict__ delta, float* __restrict__ dq, int N, int M, float scale_log2,
                            float scale) {
  using T = DqF32Tiles<D>;
  using R = typename T::Rows;
  using RT = typename T::RowsT;
  constexpr int BK = T::kKeys;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte aligned bases.
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;  // Q, Q lo, dO, dO lo
  const uint32_t qlo_s = q_s + T::kQBytes;
  const uint32_t do_s = qlo_s + T::kQBytes;
  const uint32_t dolo_s = do_s + T::kQBytes;
  const uint32_t k_s = dolo_s + T::kQBytes;                  // per stage: K, K lo, K^T, K^T lo
  const uint32_t v_s = k_s + S * T::kKStage;                 // per stage: V, V lo
  const uint32_t q_full = v_s + S * T::kVStage;              // then the K/V ring's barriers
  const KvRing<S> ring{q_full};
  auto k_at = [&](int st) { return k_s + st * T::kKStage; };
  auto v_at = [&](int st) { return v_s + st * T::kVStage; };

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
    if constexpr (T::kConsumers > 1) setmaxnreg_dec<T::kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, 4 * T::kQBytes);
      R::load(q_s, &m.q, q_full, 0, q0, T::kRowsQ, b);
      R::load(qlo_s, &m.q_lo, q_full, 0, q0, T::kRowsQ, b);
      R::load(do_s, &m.dout, q_full, 0, q0, T::kRowsQ, b);
      R::load(dolo_s, &m.do_lo, q_full, 0, q0, T::kRowsQ, b);
      int st = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const uint32_t k = k_at(st), v = v_at(st);
        mbar_wait(ring.k_empty(st), phase ^ 1);
        mbar_arrive_expect_tx(ring.k_full(st), T::kKStage);
        R::load(k, &m.k, ring.k_full(st), 0, t * BK, BK, b);
        R::load(k + T::kTileBytes, &m.k_lo, ring.k_full(st), 0, t * BK, BK, b);
        RT::load(k + 2 * T::kTileBytes, &m.kt, ring.k_full(st), t * BK, 0, D, b);
        RT::load(k + 3 * T::kTileBytes, &m.kt_lo, ring.k_full(st), t * BK, 0, D, b);
        mbar_wait(ring.v_empty(st), phase ^ 1);
        mbar_arrive_expect_tx(ring.v_full(st), T::kVStage);
        R::load(v, &m.v, ring.v_full(st), 0, t * BK, BK, b);
        R::load(v + T::kTileBytes, &m.v_lo, ring.v_full(st), 0, t * BK, BK, b);
        if (++st == S) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 Q rows each ----
    if constexpr (T::kConsumers > 1) setmaxnreg_inc<T::kConsumerRegs>();
    // Warp-uniform by construction (a shuffle from lane 0), so descriptors stay in uniform registers.
    const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0) - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
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

    // dq_part: one tile's dS K, added to dq_acc in fp32 (add_to).
    float s[BK / 2], dp[BK / 2], dq_acc[D / 2], dq_part[D / 2];
    uint32_t ds_hi[BK / 8][4], ds_lo[BK / 8][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    // S = Q K^T and dP = dO V^T, every operand K-major.
    auto sdp_issue = [&](int st) {
      const uint32_t q = opaque(q_s), k = opaque(k_at(st)), v = opaque(v_at(st));
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        wgmma_3xtf32_ss<BK>(s, R::k_major(q, T::kRowsQ, wg * 64, kk),
                            R::k_major(q + T::kQBytes, T::kRowsQ, wg * 64, kk), R::k_major(k, BK, 0, kk),
                            R::k_major(k + T::kTileBytes, BK, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        wgmma_3xtf32_ss<BK>(dp, R::k_major(q + 2 * T::kQBytes, T::kRowsQ, wg * 64, kk),
                            R::k_major(q + 3 * T::kQBytes, T::kRowsQ, wg * 64, kk), R::k_major(v, BK, 0, kk),
                            R::k_major(v + T::kTileBytes, BK, 0, kk), kk > 0);
      }
    };
    // dQ part = dS K: B is the stage's K^T, K-major over the permuted keys.
    auto dq_issue = [&](int st) {
      const uint32_t kt = opaque(k_at(st)) + 2 * T::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        wgmma_3xtf32_rs<D>(dq_part, ds_hi[kk], ds_lo[kk], RT::k_major(kt, D, 0, kk),
                           RT::k_major(kt + T::kTileBytes, D, 0, kk), kk > 0);
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
    auto fence_dq = [&]() {  // the operands of dq_issue
      fence_regs(dq_part);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
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
    to_tf32_frags<BK>(dp, ds_hi, ds_lo);

    // Tile t: issue S(t) and dP(t), then dQ += dS(t-1) K(t-1); dS(t) is
    // computed while that product runs and split once it has retired.  The
    // last tile takes its own step, so the loop carries no key mask.
    auto step = [&](int t, bool mask) {
      mbar_wait(ring.k_full(stage(t)), parity(t));
      mbar_wait(ring.v_full(stage(t)), parity(t));
      // Turns: warpgroup 0 issues tile t's products, then warpgroup 1 (barrier
      // 1 + wg is this warpgroup's turn, signalled by the other one).
      if (T::kPingPong && !(wg == 0 && t == 1)) named_bar_sync(1 + wg, 256);
      fence_regs(s);
      fence_regs(dp);
      fence_dq();
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
      fence_dq();
      if (lane == 0) mbar_arrive(ring.k_empty(stage(t - 1)));
      add_to(dq_acc, dq_part);
      to_tf32_frags<BK>(dp, ds_hi, ds_lo);
    };
    for (int t = 1; t < n_tiles - 1; ++t) step(t, false);
    if (n_tiles > 1) step(n_tiles - 1, ragged);
    fence_dq();
    wgmma_fence();
    dq_issue(stage(n_tiles - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_dq();
    add_to(dq_acc, dq_part);

    store_rows_f32<D>(dq_acc, dq + (size_t)b * N * D, row_a, N, scale, scale, t4);
  }
}

template <int D>
__global__ void __launch_bounds__(DkvF32Tiles<D>::kThreads, 1)
    flash_bwd_dkv_f32_kernel(const __grid_constant__ F32Maps m, const float* __restrict__ lse,
                             const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int N,
                             int M, float scale_log2, float scale) {
  using T = DkvF32Tiles<D>;
  using R = typename T::Rows;
  using RT = typename T::RowsT;
  constexpr int BQ = T::kQueries;
  constexpr int S = T::kStages;
  constexpr int DC = T::kCols;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte aligned bases.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023u) & ~1023u;              // K, K lo, V, V lo
  const uint32_t klo_s = k_s + T::kKVBytes;
  const uint32_t v_s = klo_s + T::kKVBytes;
  const uint32_t vlo_s = v_s + T::kKVBytes;
  const uint32_t st_s = vlo_s + T::kKVBytes;                // stages
  const uint32_t vec_s = st_s + S * T::kStageBytes;         // per stage: lse * log2(e) [BQ], then delta [BQ]
  const uint32_t bar = vec_s + S * T::kVecBytes;            // kv_full, then full[S], empty[S]
  float* vecs = reinterpret_cast<float*>(smem_raw + (vec_s - raw));
  const uint32_t kv_full = bar;
  auto full = [&](int st) { return bar + 8 * (1 + st); };
  auto empty = [&](int st) { return bar + 8 * (1 + S + st); };
  // Tile i of stage st: 0 Q, 1 Q lo, 2 dO, 3 dO lo, 4 Q^T, 5 Q^T lo, 6 dO^T, 7 dO^T lo.
  auto tile = [&](int st, int i) { return st_s + st * T::kStageBytes + i * T::kTileBytes; };

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
    if constexpr (T::kConsumers > 1) setmaxnreg_dec<T::kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 4 * T::kKVBytes);
        R::load(k_s, &m.k, kv_full, 0, k0, T::kRowsKV, b);
        R::load(klo_s, &m.k_lo, kv_full, 0, k0, T::kRowsKV, b);
        R::load(v_s, &m.v, kv_full, 0, k0, T::kRowsKV, b);
        R::load(vlo_s, &m.v_lo, kv_full, 0, k0, T::kRowsKV, b);
      }
      // Lane 0 issues the TMA loads of the stage; every lane copies its share
      // of the stage's lse * log2(e) and delta (read before the stage is free)
      // and then arrives.
      constexpr int kPer = (BQ + 31) / 32;
      const float* lse_b = lse + (size_t)b * N;
      const float* delta_b = delta + (size_t)b * N;
      int st = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        float l2[kPer], dl[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int row = t * BQ + 32 * i + lane;
          l2[i] = row < N ? lse_b[row] * kLog2e : INFINITY;  // queries past N: P = 0
          dl[i] = row < N ? delta_b[row] : 0.f;
        }
        mbar_wait(empty(st), phase ^ 1);
        float* vec = vecs + st * 2 * BQ;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          if (32 * i + lane < BQ) {
            vec[32 * i + lane] = l2[i];
            vec[BQ + 32 * i + lane] = dl[i];
          }
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full(st), T::kStageBytes);
          R::load(tile(st, 0), &m.q, full(st), 0, t * BQ, BQ, b);
          R::load(tile(st, 1), &m.q_lo, full(st), 0, t * BQ, BQ, b);
          R::load(tile(st, 2), &m.dout, full(st), 0, t * BQ, BQ, b);
          R::load(tile(st, 3), &m.do_lo, full(st), 0, t * BQ, BQ, b);
          RT::load(tile(st, 4), &m.qt, full(st), t * BQ, 0, D, b);
          RT::load(tile(st, 5), &m.qt_lo, full(st), t * BQ, 0, D, b);
          RT::load(tile(st, 6), &m.dot, full(st), t * BQ, 0, D, b);
          RT::load(tile(st, 7), &m.dot_lo, full(st), t * BQ, 0, D, b);
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
    // ---- consumer warpgroups: 64 K/V rows each (at D=128 the same 64, half of D each) ----
    if constexpr (T::kConsumers > 1) setmaxnreg_inc<T::kConsumerRegs>();
    const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0) - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int row0 = T::kSplitD ? 0 : wg * 64;  // this warpgroup's K/V rows in the CTA's tiles
    const int col0 = T::kSplitD ? wg * DC : 0;  // and its columns of dK, dV

    // Transposed tiles: rows are this warpgroup's keys, columns the BQ queries.
    // dk_part, dv_part: one tile's products, added to dk_acc, dv_acc in fp32.
    float st_acc[BQ / 2], dpt[BQ / 2], dk_acc[DC / 2], dv_acc[DC / 2], dk_part[DC / 2], dv_part[DC / 2];
    uint32_t pt_hi[BQ / 8][4], pt_lo[BQ / 8][4], ds_hi[BQ / 8][4], ds_lo[BQ / 8][4];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }

    // S^T = K Q^T and dP^T = V dO^T, every operand K-major: K and V (owned)
    // as A, the stage's Q and dO as B.
    auto sdp_issue = [&](int st) {
      const uint32_t kv = opaque(k_s), x = opaque(tile(st, 0));
      auto owned = [&](int i, int kk) { return R::k_major(kv + i * T::kKVBytes, T::kRowsKV, row0, kk); };
      auto walked = [&](int i, int kk) { return R::k_major(x + i * T::kTileBytes, BQ, 0, kk); };
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        wgmma_3xtf32_ss<BQ>(st_acc, owned(0, kk), owned(1, kk), walked(0, kk), walked(1, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        wgmma_3xtf32_ss<BQ>(dpt, owned(2, kk), owned(3, kk), walked(2, kk), walked(3, kk), kk > 0);
      }
    };
    // dV part = P^T dO and dK part = dS^T Q: B is the stage's dO^T and Q^T
    // (this warpgroup's DC of their D rows), K-major over the permuted queries.
    auto dkv_issue = [&](int st) {
      const uint32_t x = opaque(tile(st, 0));
      auto walked_t = [&](int i, int kk) { return RT::k_major(x + i * T::kTileBytes, D, col0, kk); };
#pragma unroll
      for (int kk = 0; kk < BQ / 8; ++kk) {
        wgmma_3xtf32_rs<DC>(dv_part, pt_hi[kk], pt_lo[kk], walked_t(6, kk), walked_t(7, kk), kk > 0);
        wgmma_3xtf32_rs<DC>(dk_part, ds_hi[kk], ds_lo[kk], walked_t(4, kk), walked_t(5, kk), kk > 0);
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
    auto split = [&]() {
      to_tf32_frags<BQ>(st_acc, pt_hi, pt_lo);
      to_tf32_frags<BQ>(dpt, ds_hi, ds_lo);
    };
    auto fence_second = [&]() {  // the operands of dkv_issue
      fence_regs(dk_part);
      fence_regs(dv_part);
      fence_regs(pt_hi);
      fence_regs(pt_lo);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
    };
    auto stage = [](int t) { return t % S; };
    auto parity = [](int t) { return (uint32_t)((t / S) & 1); };

    auto scores = [&](int st) {  // S^T, dP^T of the tile in stage st, then P^T, dS^T, split
      fence_regs(st_acc);
      fence_regs(dpt);
      wgmma_fence();
      sdp_issue(st);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st_acc);
      fence_regs(dpt);
      grads(st);
      split();
    };

    mbar_wait(kv_full, 0);
    if constexpr (S == 1) {
      // One stage: each tile's scores, then its dV, dK parts, then release.
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(full(0), t & 1);
        scores(0);
        fence_second();
        wgmma_fence();
        dkv_issue(0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_second();
        if (lane == 0) mbar_arrive(empty(0));
        add_to(dk_acc, dk_part);
        add_to(dv_acc, dv_part);
      }
    } else {
      // Tile 0.
      mbar_wait(full(0), 0);
      scores(0);

      // Tile t: issue S^T(t) and dP^T(t), then dV and dK of tile t - 1; P^T(t)
      // and dS^T(t) are computed while those run and split once they have retired.
      for (int t = 1; t < n_tiles; ++t) {
        mbar_wait(full(stage(t)), parity(t));
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
        add_to(dk_acc, dk_part);
        add_to(dv_acc, dv_part);
        split();
      }
      fence_second();
      wgmma_fence();
      dkv_issue(stage(n_tiles - 1));
      wgmma_commit();
      wgmma_wait<0>();
      fence_second();
      add_to(dk_acc, dk_part);
      add_to(dv_acc, dv_part);
    }

    const int row_a = k0 + row0 + warp * 16 + g;
    store_rows_f32<DC, D>(dk_acc, dk + (size_t)b * M * D + col0, row_a, M, scale, scale, t4);
    store_rows_f32<DC, D>(dv_acc, dv + (size_t)b * M * D + col0, row_a, M, 1.f, 1.f, t4);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const void* const* parts;  // the fp32 kernels' extra operands (enum Part), or null for bf16
  int B, N, M;
  float scale;
  cudaStream_t stream;
};

// The fp32 kernels' tensor maps: the parts of Q, dO in tiles of `rows_q`
// rows, of K, V in tiles of `rows_kv`; the transposed copies (rows of
// length rounded up to kTransposePad) in tiles of `cols_t` columns and D rows.
template <int D>
bool encode_f32_maps(F32Maps* m, const Args& a, int rows_q, int rows_kv, int cols_t) {
  const int box = SwizzledRows<D, 4>::kBox, box_t = cols_t < 32 ? cols_t : 32;
  const int np = (a.N + kTransposePad - 1) / kTransposePad * kTransposePad;
  const int mp = (a.M + kTransposePad - 1) / kTransposePad * kTransposePad;
  const void* const* p = a.parts;
  return encode_map(&m->q, p[kQHi], a.B, a.N, D, box, rows_q, 4) &&
         encode_map(&m->q_lo, p[kQLo], a.B, a.N, D, box, rows_q, 4) &&
         encode_map(&m->dout, p[kDoHi], a.B, a.N, D, box, rows_q, 4) &&
         encode_map(&m->do_lo, p[kDoLo], a.B, a.N, D, box, rows_q, 4) &&
         encode_map(&m->k, p[kKHi], a.B, a.M, D, box, rows_kv, 4) &&
         encode_map(&m->k_lo, p[kKLo], a.B, a.M, D, box, rows_kv, 4) &&
         encode_map(&m->v, p[kVHi], a.B, a.M, D, box, rows_kv, 4) &&
         encode_map(&m->v_lo, p[kVLo], a.B, a.M, D, box, rows_kv, 4) &&
         encode_map(&m->qt, p[kQt], a.B, D, np, box_t, D, 4) &&
         encode_map(&m->qt_lo, p[kQtLo], a.B, D, np, box_t, D, 4) &&
         encode_map(&m->dot, p[kDot], a.B, D, np, box_t, D, 4) &&
         encode_map(&m->dot_lo, p[kDotLo], a.B, D, np, box_t, D, 4) &&
         encode_map(&m->kt, p[kKt], a.B, D, mp, box_t, D, 4) &&
         encode_map(&m->kt_lo, p[kKtLo], a.B, D, mp, box_t, D, 4);
}

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
    static const cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<D>, T::kSmemBytes);  // once per kernel
    if (err != cudaSuccess) return err;
    const dim3 grid((a.N + T::kRowsQ - 1) / T::kRowsQ, a.B);
    flash_bwd_dq_bf16_kernel<D><<<grid, T::kThreads, T::kSmemBytes, a.stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(dq), a.N, a.M, sl2, a.scale);
  } else {
    using T = DqF32Tiles<D>;
    F32Maps m;
    if (a.parts == nullptr || !encode_f32_maps<D>(&m, a, T::kRowsQ, T::kKeys, T::kKeys)) return cudaErrorInvalidValue;
    static const cudaError_t err = allow_smem(flash_bwd_dq_f32_kernel<D>, T::kSmemBytes);  // once per kernel
    if (err != cudaSuccess) return err;
    const dim3 grid((a.N + T::kRowsQ - 1) / T::kRowsQ, a.B);
    flash_bwd_dq_f32_kernel<D><<<grid, T::kThreads, T::kSmemBytes, a.stream>>>(
        m, a.lse, a.delta, static_cast<float*>(dq), a.N, a.M, sl2, a.scale);
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
    static const cudaError_t err = allow_smem(flash_bwd_dkv_bf16_kernel<D>, T::kSmemBytes);  // once per kernel
    if (err != cudaSuccess) return err;
    const dim3 grid((a.M + T::kRowsKV - 1) / T::kRowsKV, a.B);
    using E = __nv_bfloat16;
    flash_bwd_dkv_bf16_kernel<D><<<grid, T::kThreads, T::kSmemBytes, a.stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, static_cast<E*>(dk), static_cast<E*>(dv), a.N, a.M, sl2, a.scale);
  } else {
    using T = DkvF32Tiles<D>;
    F32Maps m;
    if (a.parts == nullptr || !encode_f32_maps<D>(&m, a, T::kQueries, T::kRowsKV, T::kQueries)) {
      return cudaErrorInvalidValue;
    }
    static const cudaError_t err = allow_smem(flash_bwd_dkv_f32_kernel<D>, T::kSmemBytes);  // once per kernel
    if (err != cudaSuccess) return err;
    const dim3 grid((a.M + T::kRowsKV - 1) / T::kRowsKV, a.B);
    flash_bwd_dkv_f32_kernel<D><<<grid, T::kThreads, T::kSmemBytes, a.stream>>>(
        m, a.lse, a.delta, static_cast<float*>(dk), static_cast<float*>(dv), a.N, a.M, sl2, a.scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, dout, dq [B,N,D]; k, v, dk, dv [B,M,D] (all contiguous, same dtype, 16-byte
// aligned: the kernels read q, k, v, dout through TMA tensor maps); lse, delta
// [B,N] fp32.  is_bf16 selects bf16 (1) or fp32 (0); D is 32, 64 or 128.
// parts: for fp32, a host array of the device pointers of enum Part (made by
// flash_attention.py::tf32_parts, each contiguous and 16-byte aligned); null
// for bf16.  Each returns the cudaError_t of its launch (0 on success).
extern "C" int mrisr_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, int B, int N, int M, int D, int is_bf16,
                                       float scale, const void* const* parts, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               parts, B, N, M, scale, static_cast<cudaStream_t>(stream)};
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
                                        int is_bf16, float scale, const void* const* parts, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               parts, B, N, M, scale, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return (int)launch_dkv<32>(a, dk, dv, is_bf16 != 0);
    case 64: return (int)launch_dkv<64>(a, dk, dv, is_bf16 != 0);
    case 128: return (int)launch_dkv<128>(a, dk, dv, is_bf16 != 0);
  }
  return (int)cudaErrorInvalidValue;
}
