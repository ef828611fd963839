// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// (built by mrisr_torch/_build.py, loaded with ctypes by
// mrisr_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel mrisr_tpu/ops/flash_attention.py::_flash_kernel,
// launched by _flash_forward: non-causal softmax(scale * Q K^T) V on [B, N, D]
// with an online softmax over K/V tiles, the running max, sum and accumulator
// in fp32, O written in the input dtype and the row logsumexp (natural log)
// in fp32.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), at the
// heaviest call of the serving chain -- the cross-attention at the 128^2 skip,
// exact profile: B=8, N=M=16384, D=32, bf16:
//   * matrix products: 4*B*N*M*D = 275 GFLOP -> 0.28 ms on the tensor cores;
//   * exponentials: B*N*M = 2.1 G -> about 0.58 ms at the 16 per clock per SM
//     of the special-function units.  At D=32 the exponentials, not the
//     tensor cores, set the floor (the TPU kernel was VPU-bound for the same
//     reason), so every other instruction per score competes with them;
//   * bytes: ~34 MB -> 10 us.
// At the 64^2 skip (8x4096x4096x64) the tensor-core and exp floors are about
// equal (0.035 and 0.036 ms).  With K/V pooled 8x8 (M=256 or 64) the call is
// bound by bytes (a few us) and by the wrapper's host time.
//
// bf16 design (FlashAttention-3's shape, written in raw PTX: hopper.cuh).
// Choices marked (sweep) were timed against the alternative named, in turns
// on one H100, by mrisr_torch/tools/flash_fwd_sweep.py (numbers in PERF.md).
//   * One CTA per (batch, 128 Q rows): a producer warpgroup and two consumer
//     warpgroups of 64 Q rows each; setmaxnreg gives the producer 24
//     registers a thread and the consumers 240.  The TPU carried m/l/acc
//     across a sequential grid axis; here the K/V loop runs inside the CTA.
//     Three consumer warpgroups (192 rows, 160 registers) at D=32 were
//     5-10 % slower (sweep).  At D=64 the 8x4096 grid is 256 CTAs, under
//     two waves on 132 SMs; 264 CTAs (two full waves) take no less time
//     (sweep), so the partly empty second wave costs nothing measurable and
//     128-row CTAs are kept (no smaller CTAs, no persistent tile loop).
//   * One elected producer thread loads Q once and K and V tiles of BK=128
//     keys into a ring of kStages shared-memory stages with TMA
//     (cp.async.bulk.tensor over 3-D tensor maps [B, rows, D], so the
//     zero fill past the last row happens per batch).  Each stage has a
//     full and an empty mbarrier for K and for V.  Rows are 64 bytes at
//     D=32 (64B swizzle), 128 bytes at D=64 (128B swizzle), and D=128 is two
//     boxes of 64 columns (128B swizzle).  BK is 128 at every D: S (64
//     registers) plus P (32) plus O (16-64) fit in 240; BK=256 at D=32 was
//     22-30 % slower (sweep).
//   * S = Q K^T with wgmma m64n128k16, both operands K-major shared-memory
//     descriptors.  Per tile t a consumer issues S(t), rescales O, issues
//     O += P(t-1) V(t-1), runs the softmax of S(t) while that product runs,
//     and packs P(t) once it has retired.  At D=64 S(t+1) is issued too,
//     into a second S buffer, before the softmax of tile t (8-17 % faster
//     there; 0-4 % slower at D=32; no room at D=128; sweep).  At D=128 the
//     two consumers take turns issuing on named barriers, so one's
//     exponentials overlap the other's products (0-11 % faster; 0-3 %
//     slower at D=32 and 4 % at D=64 with S issued ahead; sweep).
//   * Softmax on the accumulators: the row max over raw scores (four
//     independent chains, then two quad shuffles; one chain was 2-12 %
//     slower at D=32; sweep), then each score is one FFMA
//     (s * scale*log2(e) - m) and one ex2.approx.  Keys >= M are masked
//     only in the last tile, and only when M % BK != 0.
//   * O += P V with the RS form: P leaves the S accumulators as bf16 A
//     fragments by packing adjacent pairs (the accumulator and A-fragment
//     layouts line up), and V is an MN-major B operand read with wgmma's
//     transpose bit.
//   * The denominator sums the bf16-rounded p, as the reference's V_AUG does,
//     on the tensor cores: one wgmma m64n8k16 per k-step against a tile of
//     ones in shared memory gives the row sums of P in fp32 with no
//     per-score add (summing in registers was 39-48 % slower at D=32 and
//     0-8 % at D=64; sweep).
//   * wgmma operands are pinned with fence_regs around each batch: a write
//     to them that the compiler moves inside a batch makes ptxas serialize
//     every wgmma of the kernel (notes C7511/C7513/C7515; chip_smoke.py's
//     build phase fails on them).
//   * Epilogue: O / l in bf16 and lse = m ln2 + ln l, rows past N not stored.
//   * fp32: plain FMA (no TF32), 4 threads per Q row, each owning a quarter
//     of D; K/V tiles of 32 rows in shared memory, 16 keys per softmax update.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;  // Q rows per block of the fp32 kernel

// Tile table of the bf16 kernel, per head dimension D.
template <int D>
struct Bf16Tiles : SwizzledRows<D> {
  static constexpr int kConsumers = 2;               // consumer warpgroups, 64 Q rows each
  static constexpr int kRowsQ = 64 * kConsumers;     // Q rows per CTA
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // Registers a thread after setmaxnreg: the producer gives up what the
  // consumers take, from the 65536 / kThreads each starts with.
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 160;
  static constexpr int kKeys = 128;                  // BK: keys per K/V tile
  static constexpr int kStages = D == 128 ? 2 : (D == 64 ? 3 : 4);
  // Measured per D (mrisr_torch/tools/flash_fwd_sweep.py): S(t+1) issued
  // ahead of the softmax of tile t into a second S buffer (64 more registers
  // a thread; no room at D=128) pays at D=64 only; the two consumer
  // warpgroups taking turns on named barriers pays at D=128 only.
  static constexpr bool kIssueAhead = D == 64;
  static constexpr bool kPingPong = D == 128;
  static_assert(!kPingPong || kConsumers == 2, "turns are taken between two consumer warpgroups");
  static constexpr int kQBytes = kRowsQ * D * 2;
  static constexpr int kTileBytes = kKeys * D * 2;   // one K (or V) stage
  static constexpr int kOnesBytes = 1024;
  static constexpr int kBarBytes = 8 + KvRing<kStages>::kBarBytes;
  // Shared memory: Q, K stages, V stages, ones, barriers, plus slack to align the base to 1024.
  static constexpr int kSmemBytes = kQBytes + 2 * kStages * kTileBytes + kOnesBytes + kBarBytes + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory per block");
};

// The online-softmax update of one score tile, in place.  s: this thread's
// scores of rows g and g+8 (wgmma layout), replaced by exp2(s * sl2 - m);
// m0/m1: running row maxima in log2 units; a0/a1: the factor the previous O
// and l must be scaled by.  Keys >= valid are masked when `mask` is set.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float& m0, float& m1, float& a0, float& a1,
                                             float sl2, bool mask, int valid, int t4) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j * 8 + t4 * 2 + (e & 1) >= valid) s[4 * j + e] = -INFINITY;
      }
    }
  }
  // Row maxima as four independent chains per row, so the exponentials wait
  // on a short dependency chain.
  float c0[4], c1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c0[i] = fmaxf(s[4 * i], s[4 * i + 1]);
    c1[i] = fmaxf(s[4 * i + 2], s[4 * i + 3]);
  }
#pragma unroll
  for (int j = 4; j < BK / 8; ++j) {
    c0[j % 4] = fmaxf(c0[j % 4], fmaxf(s[4 * j], s[4 * j + 1]));
    c1[j % 4] = fmaxf(c1[j % 4], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float mx0 = fmaxf(fmaxf(c0[0], c0[1]), fmaxf(c0[2], c0[3]));
  float mx1 = fmaxf(fmaxf(c1[0], c1[1]), fmaxf(c1[2], c1[3]));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // scale_log2 > 0, so the max of the scaled scores is the scaled max.  Every
  // tile holds a valid key, so the new maxima are finite; on the first tile
  // the old ones are -inf and a0 = a1 = 0.
  const float n0 = fmaxf(m0, mx0 * sl2), n1 = fmaxf(m1, mx1 * sl2);
  a0 = ex2(m0 - n0);
  a1 = ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], sl2, -n0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl2, -n0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl2, -n1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl2, -n1));
  }
}

template <int D>
__global__ void __launch_bounds__(Bf16Tiles<D>::kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int N, int M, float scale_log2) {
  using T = Bf16Tiles<D>;
  constexpr int BK = T::kKeys;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte aligned bases.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + T::kQBytes;
  const uint32_t v_s = k_s + S * T::kTileBytes;
  const uint32_t ones_s = v_s + S * T::kTileBytes;
  const uint32_t q_full = ones_s + T::kOnesBytes;  // then the K/V ring's barriers
  const KvRing<S> ring{q_full};

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * T::kRowsQ;
  const int n_tiles = (M + BK - 1) / BK;

  {  // a tile of bf16 ones, the B operand of the denominator's product
    uint32_t* ones = reinterpret_cast<uint32_t*>(smem + (ones_s - base));
    for (int i = threadIdx.x; i < T::kOnesBytes / 4; i += T::kThreads) ones[i] = 0x3F803F80u;
  }
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    ring.init(4 * T::kConsumers);
    fence_barrier_init();
  }
  fence_proxy_async();
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    setmaxnreg_dec<T::kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int x = 0; x < T::kBoxes; ++x) {
        tma_load_3d(q_s + x * T::kRowsQ * T::kRowBytes, &tq, q_full, x * T::kBox, q0, b);
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

    // S = Q K^T: one descriptor pair per 16-column k-step of D.
    auto qk_issue = [&](float (&s)[BK / 2], int st) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<BK>(s, T::k_major(q_s, T::kRowsQ, wg * 64, kk), T::k_major(k_s + st * T::kTileBytes, BK, 0, kk),
                     kk > 0);
      }
    };
    float o_acc[D / 2];
    float l_acc[4];
    // O += P V and l += P 1: V is MN-major (D contiguous).
    auto pv_issue = [&](const uint32_t (&p)[BK / 16][4], int st) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_rs<D>(o_acc, p[kk], T::mn_major(v_s + st * T::kTileBytes, BK, kk));
        wgmma_rs<8>(l_acc, p[kk], make_desc(ones_s, 128, 256, 0));
      }
    };

#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) l_acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, a0, a1;
    const bool ragged = M % BK != 0;
    const int last_valid = M - (n_tiles - 1) * BK;

    float s[BK / 2];
    uint32_t p[BK / 16][4];
    // Scale O and l by the factor of the latest softmax (before P V adds the tile it belongs to).
    auto rescale = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o_acc[4 * j] *= a0;
        o_acc[4 * j + 1] *= a0;
        o_acc[4 * j + 2] *= a1;
        o_acc[4 * j + 3] *= a1;
      }
      l_acc[0] *= a0;
      l_acc[1] *= a0;
      l_acc[2] *= a1;
      l_acc[3] *= a1;
    };
    mbar_wait(q_full, 0);

    auto stage = [](int t) { return t % S; };
    auto parity = [](int t) { return (uint32_t)((t / S) & 1); };
    auto one_buffer = [&]() {  // one S buffer
      // Tile 0.
      mbar_wait(ring.k_full(0), 0);
      fence_regs(s);
      wgmma_fence();
      qk_issue(s, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(ring.k_empty(0));
      softmax_tile<BK>(s, m0, m1, a0, a1, scale_log2, ragged && n_tiles == 1, last_valid, t4);
      to_a_frags<BK>(s, p);

      // Tile t: issue S(t), then O += P(t-1) V(t-1); the softmax of S(t) runs
      // while the PV product does, and P(t) is packed once it has retired.
      for (int t = 1; t < n_tiles; ++t) {
        mbar_wait(ring.k_full(stage(t)), parity(t));
        // Turns: warpgroup 0 issues tile t's products, then warpgroup 1 (barrier
        // 1 + wg is this warpgroup's turn, signalled by the other one).
        if (T::kPingPong && !(wg == 0 && t == 1)) named_bar_sync(1 + wg, 256);
        fence_regs(s);
        wgmma_fence();
        qk_issue(s, stage(t));
        wgmma_commit();
        rescale();
        mbar_wait(ring.v_full(stage(t - 1)), parity(t - 1));
        fence_regs(o_acc);
        fence_regs(l_acc);
        fence_regs(p);
        wgmma_fence();
        pv_issue(p, stage(t - 1));
        wgmma_commit();
        if (T::kPingPong && !(wg == 1 && t == n_tiles - 1)) named_bar_arrive(2 - wg, 256);
        wgmma_wait<1>();  // S of tile t is ready; P V of tile t - 1 may still run
        fence_regs(s);
        if (lane == 0) mbar_arrive(ring.k_empty(stage(t)));
        softmax_tile<BK>(s, m0, m1, a0, a1, scale_log2, ragged && t == n_tiles - 1, last_valid, t4);
        wgmma_wait<0>();
        fence_regs(o_acc);
        fence_regs(l_acc);
        fence_regs(p);
        if (lane == 0) mbar_arrive(ring.v_empty(stage(t - 1)));
        to_a_frags<BK>(s, p);
      }
    };
    if constexpr (T::kIssueAhead) {
      // Two S buffers: S(t+1) is issued before the softmax of tile t, so its
      // latency hides behind the exponentials as well.  Every wgmma group is
      // issued and waited for on a path fixed at compile time (ptxas
      // serializes the pipeline when a group may or may not exist), so a
      // single tile takes the one-buffer path and the last tile its own step.
      if (n_tiles == 1) {
        one_buffer();
      } else {
        float s2[BK / 2];
        mbar_wait(ring.k_full(0), 0);
        mbar_wait(ring.k_full(stage(1)), parity(1));
        fence_regs(s);
        fence_regs(s2);
        wgmma_fence();
        qk_issue(s, 0);
        wgmma_commit();
        qk_issue(s2, stage(1));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        if (lane == 0) mbar_arrive(ring.k_empty(0));
        softmax_tile<BK>(s, m0, m1, a0, a1, scale_log2, false, last_valid, t4);
        to_a_frags<BK>(s, p);

        // Tile t, its S already issued into cur: issue O += P(t-1) V(t-1)
        // and (ahead) S(t+1) into nxt, run the softmax of S(t) while both
        // run, pack P(t) once the PV product has retired.  `ahead` is false
        // on the last tile only and a literal at every call, so each
        // inlined step is straight-line code.
        auto step = [&](int t, float (&cur)[BK / 2], float (&nxt)[BK / 2], bool ahead) {
          rescale();
          mbar_wait(ring.v_full(stage(t - 1)), parity(t - 1));
          if (ahead) mbar_wait(ring.k_full(stage(t + 1)), parity(t + 1));
          if (T::kPingPong && !(wg == 0 && t == 1)) named_bar_sync(1 + wg, 256);
          fence_regs(o_acc);
          fence_regs(l_acc);
          fence_regs(p);
          fence_regs(nxt);
          wgmma_fence();
          pv_issue(p, stage(t - 1));
          wgmma_commit();
          if (ahead) {
            qk_issue(nxt, stage(t + 1));
            wgmma_commit();
          }
          if (T::kPingPong && !(wg == 1 && !ahead)) named_bar_arrive(2 - wg, 256);
          if (ahead) {  // S(t) is ready
            wgmma_wait<2>();
          } else {
            wgmma_wait<1>();
          }
          fence_regs(cur);
          if (lane == 0) mbar_arrive(ring.k_empty(stage(t)));
          softmax_tile<BK>(cur, m0, m1, a0, a1, scale_log2, ragged && !ahead, last_valid, t4);
          if (ahead) {  // P(t-1) V(t-1) has retired
            wgmma_wait<1>();
          } else {
            wgmma_wait<0>();
          }
          fence_regs(o_acc);
          fence_regs(l_acc);
          fence_regs(p);
          if (lane == 0) mbar_arrive(ring.v_empty(stage(t - 1)));
          to_a_frags<BK>(cur, p);
        };
        int t = 1;
        for (; t + 2 < n_tiles; t += 2) {
          step(t, s2, s, true);
          step(t + 1, s, s2, true);
        }
        if (t + 1 < n_tiles) {
          step(t, s2, s, true);
          step(t + 1, s, s2, false);
        } else {
          step(t, s2, s, false);
        }
      }
    } else {
      one_buffer();
    }
    rescale();
    mbar_wait(ring.v_full(stage(n_tiles - 1)), parity(n_tiles - 1));
    fence_regs(o_acc);
    fence_regs(l_acc);
    fence_regs(p);
    wgmma_fence();
    pv_issue(p, stage(n_tiles - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_acc);
    fence_regs(l_acc);

    // Epilogue: every column of the n8 accumulator holds the row sum.
    const float l0 = l_acc[0], l1 = l_acc[2];
    const float inv0 = l0 > 0.f ? 1.f / l0 : 1.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 1.f;
    const int row_a = q0 + wg * 64 + warp * 16 + g;
    const int row_b = row_a + 8;
    store_rows_bf16<D>(o_acc, o + (size_t)b * N * D, row_a, N, inv0, inv1, t4);
    if (t4 == 0) {
      if (row_a < N) lse[(size_t)b * N + row_a] = m0 * kLn2 + logf(fmaxf(l0, 1e-37f));
      if (row_b < N) lse[(size_t)b * N + row_b] = m1 * kLn2 + logf(fmaxf(l1, 1e-37f));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int N, int M, float scale_log2) {
  constexpr int BK = 32;     // keys per shared-memory tile
  constexpr int CK = 16;     // keys per softmax update
  constexpr int V4 = D / 16; // float4s of D owned by each of the 4 threads of a row
  extern __shared__ float4 smem_f4[];
  float4* Ks = smem_f4;
  float4* Vs = smem_f4 + BK * (D / 4);

  const int b = blockIdx.y;
  const int row = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const int qrow = blockIdx.x * kBlockQ + row;
  const bool valid = qrow < N;
  // Thread `part` owns the float4s j*4 + part of its row, so the 4 threads of
  // a row read 64 consecutive bytes of a K/V row: no bank conflicts.
  float4 qv[V4], acc[V4];
  const float4* qr = reinterpret_cast<const float4*>(q + ((size_t)b * N + qrow) * D);
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    qv[j] = valid ? qr[j * 4 + part] : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4* kb = reinterpret_cast<const float4*>(k + (size_t)b * M * D);
  const float4* vb = reinterpret_cast<const float4*>(v + (size_t)b * M * D);

  float m_run = -INFINITY, l_run = 0.f;
  const int n_tiles = (M + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    for (int c = threadIdx.x; c < BK * (D / 4); c += 256) {
      const int r = c / (D / 4);
      const bool in = k0 + r < M;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      Ks[c] = in ? kb[(size_t)k0 * (D / 4) + c] : zero;
      Vs[c] = in ? vb[(size_t)k0 * (D / 4) + c] : zero;
    }
    __syncthreads();

    for (int c0 = 0; c0 < BK; c0 += CK) {
      float sc[CK];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float4* kr = Ks + (c0 + c) * (D / 4);
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < V4; ++j) {
          const float4 kk = kr[j * 4 + part];
          d = fmaf(qv[j].x, kk.x, d);
          d = fmaf(qv[j].y, kk.y, d);
          d = fmaf(qv[j].z, kk.z, d);
          d = fmaf(qv[j].w, kk.w, d);
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        sc[c] = (k0 + c0 + c < M) ? d * scale_log2 : -INFINITY;
        mx = fmaxf(mx, sc[c]);
      }
      // Chunk 0 of tile 0 holds key 0, so m_new is always finite.
      const float m_new = fmaxf(m_run, mx);
      const float alpha = exp2f(m_run - m_new);
      m_run = m_new;
      l_run *= alpha;
#pragma unroll
      for (int j = 0; j < V4; ++j) {
        acc[j].x *= alpha;
        acc[j].y *= alpha;
        acc[j].z *= alpha;
        acc[j].w *= alpha;
      }
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float p = exp2f(sc[c] - m_run);
        l_run += p;
        const float4* vr = Vs + (c0 + c) * (D / 4);
#pragma unroll
        for (int j = 0; j < V4; ++j) {
          const float4 vv = vr[j * 4 + part];
          acc[j].x = fmaf(p, vv.x, acc[j].x);
          acc[j].y = fmaf(p, vv.y, acc[j].y);
          acc[j].z = fmaf(p, vv.z, acc[j].z);
          acc[j].w = fmaf(p, vv.w, acc[j].w);
        }
      }
    }
  }

  if (valid) {
    const float inv = l_run > 0.f ? 1.f / l_run : 1.f;
    float4* orow = reinterpret_cast<float4*>(o + ((size_t)b * N + qrow) * D);
#pragma unroll
    for (int j = 0; j < V4; ++j) {
      orow[j * 4 + part] =
          make_float4(acc[j].x * inv, acc[j].y * inv, acc[j].z * inv, acc[j].w * inv);
    }
    if (part == 0) lse[(size_t)b * N + qrow] = m_run * kLn2 + logf(fmaxf(l_run, 1e-37f));
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int N, int M, float scale_log2, cudaStream_t stream) {
  using T = Bf16Tiles<D>;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, B, N, D, T::kBox, T::kRowsQ) || !encode_map(&tk, k, B, M, D, T::kBox, T::kKeys) ||
      !encode_map(&tv, v, B, M, D, T::kBox, T::kKeys)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((N + T::kRowsQ - 1) / T::kRowsQ, B);
  const cudaError_t err = allow_smem(flash_fwd_bf16_kernel<D>, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  flash_fwd_bf16_kernel<D><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, N, M, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int N, int M, float scale_log2, cudaStream_t stream) {
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, B);
  const size_t smem = (size_t)2 * 32 * D * sizeof(float);
  const cudaError_t err = allow_smem(flash_fwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_f32_kernel<D><<<grid, 256, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, N, M, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q [B,N,D], k and v [B,M,D], o [B,N,D] (all contiguous, same dtype, 16-byte
// aligned), lse [B,N] fp32.  is_bf16 selects bf16 (1) or fp32 (0); D is 32,
// 64 or 128; the bf16 kernel takes scale > 0 only.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mrisr_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int N, int M, int D, int is_bf16,
                                    float scale, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const float sl2 = scale * kLog2e;
  float* l = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 32: return (int)launch_bf16<32>(q, k, v, o, l, B, N, M, sl2, st);
      case 64: return (int)launch_bf16<64>(q, k, v, o, l, B, N, M, sl2, st);
      case 128: return (int)launch_bf16<128>(q, k, v, o, l, B, N, M, sl2, st);
    }
  } else {
    switch (D) {
      case 32: return (int)launch_f32<32>(q, k, v, o, l, B, N, M, sl2, st);
      case 64: return (int)launch_f32<64>(q, k, v, o, l, B, N, M, sl2, st);
      case 128: return (int)launch_f32<128>(q, k, v, o, l, B, N, M, sl2, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
