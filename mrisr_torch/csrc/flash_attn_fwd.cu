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
//     of the special-function units (MUFU).  A share f of them on the FMA
//     pipes (Cody-Waite reduction and a degree-3 polynomial: about 9 issue
//     slots on 128 lanes against 1 slot on 16) would lower that floor to
//     (1 - f) 0.58 ms, until the issue slots of the other per-score
//     instructions (an FFMA, a max, half a pack) bind, near f = 1/3 and 0.4 ms;
//   * bytes: ~34 MB -> 10 us.
// The kernel takes 0.85-0.89 ms, 1.5x the MUFU floor, but neither floor holds
// it: with every exponential replaced by one FMUL it takes 0.07-0.10 ms less,
// and without the row max, the P pack, S = Q K^T, the rescale or the
// denominator it is as fast or slower (up to +0.26 ms; sweep ablations,
// against the same call's design): the schedule ptxas makes of the loop, not
// one unit, sets the time.  Any share of exponentials on the FMA pipes was
// slower (5/16: 1.03 ms), and so was rescaling only when a row max of the
// warp grew (at all: 1.23-1.25; by more than 8, FlashAttention-4's rule:
// 1.23-1.26), so the MUFU takes every exponential and O is rescaled after
// every tile (the sweep's poly* and rescale_* variants carry the
// alternatives).
// At the 64^2 skip (8x4096x4096x64) the tensor-core and exp floors are about
// equal (0.035 and 0.036 ms).  With K/V pooled 8x8 (M=256 or 64) the call is
// bound by bytes (a few us): each CTA of the tiled form ran two tiles of keys
// after its own set-up and loads, 7.8 waves of them (0.035 ms at M=256).  So
// short K/V at D=32 take the resident form (flash_fwd_bf16_resident_kernel,
// below; ops/flash_attention.py::fwd_form picks it up to RESIDENT_MAX_KEYS =
// 1024 keys, where it was faster than the tiled form; sweep).  At D=64 its
// gain at 64 and 256 keys was within the run-to-run spread, so D=64 keeps
// the tiled form.
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
//     O += P(t-1) V(t-1), runs the softmax of S(t), and packs P(t) once that
//     product has retired.  In the SASS the wait for it comes before the row
//     max: the assembler interleaves the packs of P(t), which reuse P(t-1)'s
//     registers, with the exponentials, so the softmax does not overlap the
//     product.  Packing into a second set of P registers let it overlap, and
//     was no faster at D=32, slower at D=128 and serialized the resident
//     form (ptxas note C7514; tried while this design was made, not kept as
//     a sweep variant).  At D=64 S(t+1) is issued too,
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
//     on the tensor cores (summing in registers was 39-48 % slower at D=32
//     and 0-8 % at D=64; sweep).  At D=32 and 64 each V stage has a tile of
//     ones beside it, where the MN-major B operand of a wgmma at N = D + 8
//     finds its last 8 columns, so one wgmma gives O and l (kOnesInV; at
//     8x16384^2x32 0.85-0.89 ms against 0.93-0.95 with a second wgmma
//     m64n8k16 per k-step against one tile of ones, which D=128 keeps; 1-3 %
//     faster at 8x4096^2x64; 4 % slower at 256 keys in the resident form;
//     sweep).  The ones go in with 16-byte stores, into the stages the loop
//     uses only: with 4-byte stores into every stage the loop ran 3-8 %
//     slower at 8x16384^2x32 and 5 % at 8x4096x64x64 (sweep).
//   * wgmma operands are pinned with fence_regs around each batch: a write
//     to them that the compiler moves inside a batch makes ptxas serialize
//     every wgmma of the kernel (notes C7511/C7513/C7515; chip_smoke.py's
//     build phase fails on them).
//   * Epilogue: O / l in bf16 and lse = m ln2 + ln l, rows past N not stored.
//
// fp32 design: 3xTF32 on the tensor cores, in the shape of the backward's
// fp32 dQ kernel (flash_attn_bwd.cu) without dO and dP.  Bound at the 128^2
// skip (8x16384^2x32): 4 B N M D = 275 GFLOP, three tf32 passes a product ->
// 1.67 ms at 495 TFLOP/s (4.1 ms as FMA at 67), the exponentials' 0.58 ms
// under it.
//   * One CTA per (batch, owned Q rows): a TMA producer warpgroup and
//     consumer warpgroups of 64 Q rows.  Q's hi and lo parts are loaded once;
//     K hi/lo and V^T hi/lo tiles of BK keys stream through the K/V ring
//     (full/empty mbarriers; K is released once S has retired, V^T once P V
//     has).  Per D (F32Tiles; sweep): two consumers and BK = 64 at D=32 and
//     D=40; one consumer at D=64 (BK 64) and D=128 (BK 32), where Q's two
//     parts of 64 rows take 32 / 64 KB.
//   * Each operand x is split into hi = x rounded to tf32 and lo = x - hi
//     rounded (to nearest: the tensor cores drop a raw operand's 13 low
//     bits), and a product takes lo hi + hi lo + hi hi.  The parts of Q, K
//     and V are made in PyTorch before the launch (tf32_fwd_parts), P's in
//     registers (to_tf32_frags).
//   * Each product goes to a fresh accumulator, its small terms (lo hi, hi
//     lo) of every k-step first and the hi hi terms last: the tensor cores
//     truncate as they add to the accumulator, and with the small terms
//     added to the large sums (the per-k-step order of the backward's
//     products) scores near -130 came out 1e-4 high, over the fp32 lse limit.
//   * S = Q K^T with wgmma_3xtf32_ss_fresh (both operands K-major as they are);
//     the scores are scaled by scale*log2(e) in registers, so one ex2 gives p
//     for any sign of the scale.  Keys past M score -inf on the last tile
//     only, which takes its own step: a zero key row would score 0, far above
//     every real score when all of them are very negative.
//   * O += P V with wgmma_3xtf32_rs_fresh: tf32 wgmma has no transpose bit, so B is
//     V^T with each group of 8 keys permuted (transpose_permuted) to match
//     the A fragments that to_tf32_frags makes of the accumulator.  Each
//     tile's product goes to a fresh accumulator, and O = alpha O + part is
//     taken in fp32 registers: the tensor cores truncate as they accumulate.
//   * The denominator is summed in fp32 registers from the same fp32 p (as
//     the reference's fp32 V_AUG column sums fp32 p): per-thread partials
//     rescaled by alpha, reduced across the quad once in the epilogue.
//   * The pipeline is the backward's one-buffer order: issue S(t), then
//     P(t-1) V(t-1); the softmax of tile t runs while that product does; two
//     consumers take turns on named barriers.  wgmma operands are pinned with
//     fence_regs and every group is issued on a path fixed at compile time.
//
// fp32 at D=40: SD1.5's heads (the latent chain's self-attention at 128^2
// latents).  Bound at the fused 1024^2 chain's 32x16384^2x40: 4 B N M D = 1.37
// TFLOP, three tf32 passes -> 8.33 ms at 495 TFLOP/s (16x: 4.16), the
// exponentials' 2.3 ms under it.  A pad to 64 makes every product 1.6x that.
//   * No pad: a 160-byte row is a 128-byte box (128B swizzle) and a 32-byte
//     tail box (32B swizzle) read through a second tensor map
//     (SwizzledRows); the tail is exactly one tf32 k-step, whose descriptor
//     names its box and swizzle mode.  S = Q K^T takes 5 k-steps; V^T tiles
//     (40 rows of BK keys) keep D=32's layout with 40 rows, and P V runs at
//     wgmma N = 40 (m64n40k8, 20 accumulator registers a thread).
//   * D=32's shape: two consumers of 64 Q rows taking turns, BK = 64 (Q's
//     parts of 128 rows take 40 KB, a stage 40 KB), 3 stages.  Sweep at 32 /
//     16 x 16384^2 x 40 (ms in PERF.md): 4 stages 2-9 % slower, 2 stages 2-5
//     %, one consumer 26-30 %, BK = 32 13-19 %; without turns 2-8 % slower.
//   * Where the time goes (sweep ablations at 32x): one tf32 pass halves the
//     time (7.3-7.5 ms of 14.1-14.8 at 4 stages), no exponentials changes
//     nothing: the three passes on the tensor cores set it.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// Tile table of the bf16 kernels (the tiled and the resident form), per head
// dimension D.
template <int D>
struct Bf16Tiles : SwizzledRows<D> {
  static constexpr int kConsumers = 2;               // consumer warpgroups, 64 Q rows each
  static constexpr int kRowsQ = 64 * kConsumers;     // Q rows per CTA
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kKeys = 128;                  // BK: keys per K/V tile
  static constexpr int kStages = D == 128 ? 2 : (D == 64 ? 3 : 4);
  // Measured per D (mrisr_torch/tools/flash_fwd_sweep.py): S(t+1) issued
  // ahead of the softmax of tile t into a second S buffer (64 more registers
  // a thread; no room at D=128) pays at D=64 only; the two consumer
  // warpgroups taking turns on named barriers pays at D=128 only.
  static constexpr bool kIssueAhead = D == 64;
  static constexpr bool kPingPong = D == 128;
  static_assert(!kPingPong || kConsumers == 2, "turns are taken between two consumer warpgroups");
  // The denominator: with kOnesInV each V tile has a tile of ones beside it
  // (where an (N = D + 8)-wide MN-major B operand finds its last 8 columns),
  // so one wgmma at N = D + 8 gives O and the row sums; else a second wgmma
  // at N = 8 against one tile of ones (sweep).
  static constexpr bool kOnesInV = D <= 64;
  static_assert(!kOnesInV || D <= 64, "the ones tile is the second box of a V tile of one box");
  static constexpr int kAccN = kOnesInV ? D + 8 : D;   // N of the P V product
  static constexpr int kQBytes = kRowsQ * D * 2;
  static constexpr int kTileBytes = kKeys * D * 2;   // one K (or V) tile
  static constexpr int kVStageBytes = kOnesInV ? 2 * kTileBytes : kTileBytes;  // a V tile and its ones
  static constexpr int kOnesBytes = 1024;
  static constexpr int kBarBytes = 8 + KvRing<kStages>::kBarBytes;
  // Shared memory: Q, K stages, V stages, ones, barriers, plus slack to align the base to 1024.
  static constexpr int kSmemBytes =
      kQBytes + kStages * (kTileBytes + kVStageBytes) + kOnesBytes + kBarBytes + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory per block");
  // The resident form (flash_fwd_bf16_resident_kernel): two Q slots, every K
  // and V tile of one batch, ones, six barriers.  It takes up to
  // kResidentTiles tiles of keys, at D=32 only (0: no resident form).
  static constexpr int kResidentTiles = D == 32 ? 1024 / kKeys : 0;
  static constexpr int resident_smem(int tiles) {
    return 2 * kQBytes + tiles * (kTileBytes + kVStageBytes) + kOnesBytes + 6 * 8 + 1024;
  }
  static_assert(resident_smem(kResidentTiles) <= 232448, "shared memory per block");
};

// The online-softmax update of one score tile, in place.  s: this thread's
// scores of rows g and g+8 (wgmma layout), replaced by exp2(s * sl2 - m);
// m0/m1: the running row maxima (log2 units); a0/a1: the factor the previous
// O and l must be scaled by.  Keys >= valid are masked when `mask` is set.
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
    s[4 * j] = ex2(fmaf(s[4 * j], sl2, -m0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl2, -m0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl2, -m1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl2, -m1));
  }
}

// Scale O and l by the factors of the latest softmax (before P V adds the
// tile they belong to).
template <class T>
__device__ __forceinline__ void rescale(float (&o)[T::kAccN / 2], float (&l)[4], float a0, float a1) {
#pragma unroll
  for (int j = 0; j < T::kAccN / 8; ++j) {
    o[4 * j] *= a0;
    o[4 * j + 1] *= a0;
    o[4 * j + 2] *= a1;
    o[4 * j + 3] *= a1;
  }
  l[0] *= a0;
  l[1] *= a0;
  l[2] *= a1;
  l[3] *= a1;
}

// Fill the bf16 ones the denominator's product reads: the tile at `ones`
// (byte offsets from `smem`), or with kOnesInV the second half of each of the
// first `tiles` V stages from `v` (only the stages the K/V loop uses: the fill
// runs before any load is issued).  Every thread of the CTA takes part, with
// 16-byte stores.
template <class T>
__device__ __forceinline__ void fill_ones(unsigned char* smem, uint32_t ones, uint32_t v, int tiles) {
  const uint4 one = make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
  if constexpr (T::kOnesInV) {
    for (int t = 0; t < tiles; ++t) {
      uint4* w = reinterpret_cast<uint4*>(smem + v + t * T::kVStageBytes + T::kTileBytes);
      for (int i = threadIdx.x; i < T::kTileBytes / 16; i += T::kThreads) w[i] = one;
    }
  } else {
    uint4* w = reinterpret_cast<uint4*>(smem + ones);
    for (int i = threadIdx.x; i < T::kOnesBytes / 16; i += T::kThreads) w[i] = one;
  }
}

// O += P V and l += P 1 for one tile of keys: V (at `v`, its ones beside it
// with kOnesInV) is an MN-major B operand (D contiguous, wgmma's transpose
// bit).  With kOnesInV the row sums land in o's last 8 columns.
template <class T, int BK = T::kKeys>
__device__ __forceinline__ void pv_product(float (&o)[T::kAccN / 2], float (&l)[4], const uint32_t (&p)[BK / 16][4],
                                           uint32_t v, uint32_t ones) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma_rs<T::kAccN>(o, p[kk], T::mn_major(v, BK, kk));
    if constexpr (!T::kOnesInV) wgmma_rs<8>(l, p[kk], make_desc(ones, 128, 256, 0));
  }
}

// The epilogue of one Q tile: O / l in bf16 and lse = m ln2 + ln l into
// batch b's rows (every column of the denominator's accumulator holds the row
// sum), rows past N not stored.  row_a: this thread's first row.
template <class T, int D>
__device__ __forceinline__ void store_tile(const float (&o_acc)[T::kAccN / 2], const float (&l_acc)[4], float m0,
                                           float m1, __nv_bfloat16* o, float* lse, int b, int N, int row_a, int t4) {
  const float l0 = T::kOnesInV ? o_acc[D / 2] : l_acc[0], l1 = T::kOnesInV ? o_acc[D / 2 + 2] : l_acc[2];
  const float inv0 = l0 > 0.f ? 1.f / l0 : 1.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 1.f;
  const int row_b = row_a + 8;
  store_rows_bf16<D>(reinterpret_cast<const float(&)[D / 2]>(o_acc), o + (size_t)b * N * D, row_a, N, inv0, inv1,
                     t4);
  if (t4 == 0) {
    if (row_a < N) lse[(size_t)b * N + row_a] = m0 * kLn2 + logf(fmaxf(l0, 1e-37f));
    if (row_b < N) lse[(size_t)b * N + row_b] = m1 * kLn2 + logf(fmaxf(l1, 1e-37f));
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
  const uint32_t ones_s = v_s + S * T::kVStageBytes;
  const uint32_t q_full = ones_s + T::kOnesBytes;  // then the K/V ring's barriers
  const KvRing<S> ring{q_full};

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * T::kRowsQ;
  const int n_tiles = (M + BK - 1) / BK;

  fill_ones<T>(smem, ones_s - base, v_s - base, n_tiles < S ? n_tiles : S);
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
      ring.template produce<T>(k_s, v_s, &tk, &tv, n_tiles, b, T::kVStageBytes);
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
    float o_acc[T::kAccN / 2];
    float l_acc[4];
    // O += P V and l += P 1: V is MN-major (D contiguous).
    auto pv_issue = [&](const uint32_t (&p)[BK / 16][4], int st) {
      pv_product<T>(o_acc, l_acc, p, v_s + st * T::kVStageBytes, ones_s);
    };

#pragma unroll
    for (int i = 0; i < T::kAccN / 2; ++i) o_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) l_acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, a0, a1;
    const bool ragged = M % BK != 0;
    const int last_valid = M - (n_tiles - 1) * BK;

    float s[BK / 2];
    uint32_t p[BK / 16][4];
    auto softmax = [&](float (&x)[BK / 2], bool mask) {
      softmax_tile<BK>(x, m0, m1, a0, a1, scale_log2, mask, last_valid, t4);
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
      softmax(s, ragged && n_tiles == 1);
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
        rescale<T>(o_acc, l_acc, a0, a1);
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
        softmax(s, ragged && t == n_tiles - 1);
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
        softmax(s, false);
        to_a_frags<BK>(s, p);

        // Tile t, its S already issued into cur: issue O += P(t-1) V(t-1)
        // and (ahead) S(t+1) into nxt, run the softmax of S(t) while both
        // run, pack P(t) once the PV product has retired.  `ahead` is false
        // on the last tile only and a literal at every call, so each
        // inlined step is straight-line code.
        auto step = [&](int t, float (&cur)[BK / 2], float (&nxt)[BK / 2], bool ahead) {
          rescale<T>(o_acc, l_acc, a0, a1);
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
          softmax(cur, ragged && !ahead);
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
    rescale<T>(o_acc, l_acc, a0, a1);
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

    store_tile<T, D>(o_acc, l_acc, m0, m1, o, lse, b, N, q0 + wg * 64 + warp * 16 + g, t4);
  }
}

// The resident form of the bf16 kernel, for short K/V (M <= kResidentTiles
// tiles of keys): a persistent grid of one CTA an SM walks the (batch, Q tile)
// items in order, each CTA a contiguous run of them, so it
// loads a batch's K and V once (all its tiles stay in shared memory) and
// switches batch at most a few times.  Q tiles go through two slots, loaded
// while the previous item runs; barriers and the ones are set up once a CTA.
// An item is the tiled kernel's one-buffer loop with no ring waits.  Running
// a CTA's items as one stream of tiles (the next item's first S issued before
// this item's last P V and epilogue) was slower at 8x16384x256x32 (tried, not
// kept as a sweep variant); CTAs of 64 Q rows, two an SM, were as fast at 256
// keys and 5-39 % slower at 512 and 1024 (rows64; sweep).
template <int D>
__global__ void __launch_bounds__(Bf16Tiles<D>::kThreads, 1)
    flash_fwd_bf16_resident_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                                   float* __restrict__ lse, int N, int M, float scale_log2, int items) {
  using T = Bf16Tiles<D>;
  constexpr int BK = T::kKeys;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int n_tiles = (M + BK - 1) / BK;
  const int q_tiles = (N + T::kRowsQ - 1) / T::kRowsQ;
  const uint32_t q_s = base;                          // Q slot x at q_s + x * kQBytes
  const uint32_t k_s = q_s + 2 * T::kQBytes;          // K tile t at k_s + t * kTileBytes
  const uint32_t v_s = k_s + n_tiles * T::kTileBytes;  // V tile t (and its ones) at v_s + t * kVStageBytes
  const uint32_t ones_s = v_s + n_tiles * T::kVStageBytes;
  const uint32_t bars = ones_s + T::kOnesBytes;
  auto q_full = [&](int x) { return bars + 8 * x; };
  auto q_empty = [&](int x) { return bars + 16 + 8 * x; };
  const uint32_t kv_full = bars + 32, kv_empty = bars + 40;
  // This CTA's items [i0, i1): item i is batch i / q_tiles, Q tile i % q_tiles.
  const int i0 = (int)((long long)blockIdx.x * items / gridDim.x);
  const int i1 = (int)((long long)(blockIdx.x + 1) * items / gridDim.x);

  fill_ones<T>(smem, ones_s - base, v_s - base, n_tiles);
  if (threadIdx.x == 0) {
    for (int x = 0; x < 2; ++x) {
      mbar_init(q_full(x), 1);
      mbar_init(q_empty(x), 4 * T::kConsumers);
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 4 * T::kConsumers);
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
      int prev_b = -1;
      uint32_t batches = 0;
      for (int i = i0, j = 0; i < i1; ++i, ++j) {
        const int b = i / q_tiles, x = j & 1;
        mbar_wait(q_empty(x), ((j >> 1) & 1) ^ 1);  // item j - 2's scores have retired
        mbar_arrive_expect_tx(q_full(x), T::kQBytes);
#pragma unroll
        for (int y = 0; y < T::kBoxes; ++y) {
          tma_load_3d(q_s + x * T::kQBytes + y * T::kRowsQ * T::kRowBytes, &tq, q_full(x), y * T::kBox,
                      (i % q_tiles) * T::kRowsQ, b);
        }
        if (b != prev_b) {  // the consumers are done with the previous batch's K and V
          mbar_wait(kv_empty, (batches & 1) ^ 1);
          mbar_arrive_expect_tx(kv_full, 2 * n_tiles * T::kTileBytes);
          for (int t = 0; t < n_tiles; ++t) {
#pragma unroll
            for (int y = 0; y < T::kBoxes; ++y) {
              tma_load_3d(k_s + t * T::kTileBytes + y * BK * T::kRowBytes, &tk, kv_full, y * T::kBox, t * BK, b);
              tma_load_3d(v_s + t * T::kVStageBytes + y * BK * T::kRowBytes, &tv, kv_full, y * T::kBox, t * BK, b);
            }
          }
          ++batches;
          prev_b = b;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 Q rows of each item each ----
    setmaxnreg_inc<T::kConsumerRegs>();
    const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0) - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const bool ragged = M % BK != 0;
    const int last_valid = M - (n_tiles - 1) * BK;

    float o_acc[T::kAccN / 2], l_acc[4], s[BK / 2];
    uint32_t p[BK / 16][4];
    float m0, m1, a0, a1;
    auto qk_issue = [&](uint32_t q, int t) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<BK>(s, T::k_major(q, T::kRowsQ, wg * 64, kk), T::k_major(k_s + t * T::kTileBytes, BK, 0, kk),
                     kk > 0);
      }
    };
    auto pv_issue = [&](int t) { pv_product<T>(o_acc, l_acc, p, v_s + t * T::kVStageBytes, ones_s); };
    auto softmax = [&](bool mask) { softmax_tile<BK>(s, m0, m1, a0, a1, scale_log2, mask, last_valid, t4); };

    int prev_b = -1;
    uint32_t batches = 0;
    for (int i = i0, j = 0; i < i1; ++i, ++j) {
      const int b = i / q_tiles, x = j & 1;
      if (b != prev_b) {
        mbar_wait(kv_full, batches & 1);
        ++batches;
        prev_b = b;
      }
      mbar_wait(q_full(x), (j >> 1) & 1);
      const uint32_t q = q_s + x * T::kQBytes;
#pragma unroll
      for (int e = 0; e < T::kAccN / 2; ++e) o_acc[e] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) l_acc[e] = 0.f;
      fence_regs(o_acc);
      fence_regs(l_acc);
      m0 = m1 = -INFINITY;

      // Tile 0, then tile t: issue S(t), then O += P(t-1) V(t-1); the
      // softmax of S(t) runs while that product does.  The Q slot is released
      // once the last S has retired.
      fence_regs(s);
      wgmma_fence();
      qk_issue(q, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (n_tiles == 1 && lane == 0) mbar_arrive(q_empty(x));
      softmax(ragged && n_tiles == 1);
      to_a_frags<BK>(s, p);
      for (int t = 1; t < n_tiles; ++t) {
        fence_regs(s);
        wgmma_fence();
        qk_issue(q, t);
        wgmma_commit();
        rescale<T>(o_acc, l_acc, a0, a1);
        fence_regs(o_acc);
        fence_regs(l_acc);
        fence_regs(p);
        wgmma_fence();
        pv_issue(t - 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        if (t == n_tiles - 1 && lane == 0) mbar_arrive(q_empty(x));
        softmax(ragged && t == n_tiles - 1);
        wgmma_wait<0>();
        fence_regs(o_acc);
        fence_regs(l_acc);
        fence_regs(p);
        to_a_frags<BK>(s, p);
      }
      rescale<T>(o_acc, l_acc, a0, a1);
      fence_regs(o_acc);
      fence_regs(l_acc);
      fence_regs(p);
      wgmma_fence();
      pv_issue(n_tiles - 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_acc);
      fence_regs(l_acc);
      // The next item is another batch: its K and V may replace these.
      if (i + 1 < i1 && (i + 1) / q_tiles != b && lane == 0) mbar_arrive(kv_empty);
      store_tile<T, D>(o_acc, l_acc, m0, m1, o, lse, b, N, (i % q_tiles) * T::kRowsQ + wg * 64 + warp * 16 + g, t4);
    }
  }
}

// ---- fp32: 3xTF32 on the tensor cores ---------------------------------------

// The operands of the fp32 kernel, made by flash_attention.py::tf32_fwd_parts
// (in this order in the `parts` argument): the high and low tf32 parts of Q
// and K (hi = x rounded to tf32, lo = x - hi rounded), and V transposed to
// [B, D, M padded to kTransposePad], high and low, each group of 8 keys
// permuted as to_tf32_frags needs.
enum Part { kQHi, kQLo, kKHi, kKLo, kVt, kVtLo };
constexpr int kTransposePad = 64;

// Tile table of the fp32 kernel, per head dimension D.  Q is in shared
// memory twice (high and low part) and each stage holds K, K lo, V^T, V^T lo.
template <int D>
struct F32Tiles {
  using Rows = SwizzledRows<D, 4>;  // Q, K tiles: D columns (at D=40 a 128-byte box and a 32-byte tail box)
  // At D=64 and 128 the owned Q tiles (64 rows, 16 bytes a column) leave room
  // for one consumer's rows only, with stages of 64 / 32 keys; D=40 has D=32's
  // shape (Q's parts of 128 rows 40 KB, a stage of 64 keys 40 KB).
  static constexpr int kConsumers = D <= 40 ? 2 : 1;
  static constexpr int kRowsQ = 64 * kConsumers;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kKeys = D == 128 ? 32 : 64;  // BK: keys per K/V tile
  using RowsT = SwizzledRows<kKeys, 4>;              // V^T tiles: BK columns
  // The loop issues tile t's scores before it releases tile t - 1: two stages at least.  At D=40 three
  // stages were 3-8 % faster than four (sweep).
  static constexpr int kStages = D == 32 ? 4 : (D == 128 ? 2 : 3);
  // The two consumer warpgroups take turns issuing on named barriers.
  static constexpr bool kPingPong = kConsumers == 2;
  static constexpr int kQBytes = kRowsQ * D * 4;     // each of Q, Q lo
  static constexpr int kTileBytes = kKeys * D * 4;   // each of K, K lo (a K stage), V^T, V^T lo (a V stage)
  static constexpr int kBarBytes = 8 + KvRing<kStages>::kBarBytes;
  // Shared memory: Q, Q lo, K stages, V stages, barriers, plus slack to align the base to 1024.
  static constexpr int kSmemBytes = 2 * kQBytes + 4 * kStages * kTileBytes + kBarBytes + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory per block");
};

// The tensor maps of the fp32 kernel: the parts it reads, and at D=40 the
// tail boxes of the D-wide ones (SwizzledRows).
struct F32Maps {
  CUtensorMap q, q_lo, k, k_lo, vt, vt_lo;
  CUtensorMap q_tail, q_lo_tail, k_tail, k_lo_tail;
};

// The online-softmax update of one fp32 score tile, in place.  s: this
// thread's raw scores of rows g and g+8 (wgmma layout), replaced by
// p = exp2(s * sl2 - m); m0/m1: running row maxima of the scaled scores
// (log2 units); a0/a1: the factor the previous O and l must be scaled by;
// l0/l1: this thread's partial row sums of p (its columns only), rescaled and
// added to here.  The scores are scaled first, so any sign of the scale
// works.  Keys >= valid are masked when `mask` is set.
template <int BK>
__device__ __forceinline__ void softmax_tile_f32(float (&s)[BK / 2], float& m0, float& m1, float& a0, float& a1,
                                                 float& l0, float& l1, float sl2, bool mask, int valid, int t4) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] *= sl2;
  if (mask) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j * 8 + t4 * 2 + (e & 1) >= valid) s[4 * j + e] = -INFINITY;
      }
    }
  }
  float c0[2], c1[2];
  c0[0] = fmaxf(s[0], s[1]);
  c1[0] = fmaxf(s[2], s[3]);
  c0[1] = fmaxf(s[4], s[5]);
  c1[1] = fmaxf(s[6], s[7]);
#pragma unroll
  for (int j = 2; j < BK / 8; ++j) {
    c0[j % 2] = fmaxf(c0[j % 2], fmaxf(s[4 * j], s[4 * j + 1]));
    c1[j % 2] = fmaxf(c1[j % 2], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float mx0 = fmaxf(c0[0], c0[1]), mx1 = fmaxf(c1[0], c1[1]);
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // Every tile holds a valid key, so the new maxima are finite; on the first
  // tile the old ones are -inf and a0 = a1 = 0.
  const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
  a0 = ex2(m0 - n0);
  a1 = ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    s[4 * j] = ex2(s[4 * j] - n0);
    s[4 * j + 1] = ex2(s[4 * j + 1] - n0);
    s[4 * j + 2] = ex2(s[4 * j + 2] - n1);
    s[4 * j + 3] = ex2(s[4 * j + 3] - n1);
    r0 += s[4 * j] + s[4 * j + 1];
    r1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = fmaf(l0, a0, r0);
  l1 = fmaf(l1, a1, r1);
}

template <int D>
__global__ void __launch_bounds__(F32Tiles<D>::kThreads, 1)
    flash_fwd_f32_kernel(const __grid_constant__ F32Maps m, float* __restrict__ o, float* __restrict__ lse, int N,
                         int M, float scale_log2) {
  using T = F32Tiles<D>;
  using R = typename T::Rows;
  using RT = typename T::RowsT;
  constexpr int BK = T::kKeys;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte aligned bases.
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;  // Q, Q lo
  const uint32_t k_s = q_s + 2 * T::kQBytes;                     // per stage: K, K lo
  const uint32_t v_s = k_s + 2 * S * T::kTileBytes;              // per stage: V^T, V^T lo
  const uint32_t q_full = v_s + 2 * S * T::kTileBytes;           // then the K/V ring's barriers
  const KvRing<S> ring{q_full};
  auto k_at = [&](int st) { return k_s + st * 2 * T::kTileBytes; };
  auto v_at = [&](int st) { return v_s + st * 2 * T::kTileBytes; };

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
      mbar_arrive_expect_tx(q_full, 2 * T::kQBytes);
      R::load(q_s, &m.q, q_full, 0, q0, T::kRowsQ, b, &m.q_tail);
      R::load(q_s + T::kQBytes, &m.q_lo, q_full, 0, q0, T::kRowsQ, b, &m.q_lo_tail);
      int st = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const uint32_t k = k_at(st), v = v_at(st);
        mbar_wait(ring.k_empty(st), phase ^ 1);
        mbar_arrive_expect_tx(ring.k_full(st), 2 * T::kTileBytes);
        R::load(k, &m.k, ring.k_full(st), 0, t * BK, BK, b, &m.k_tail);
        R::load(k + T::kTileBytes, &m.k_lo, ring.k_full(st), 0, t * BK, BK, b, &m.k_lo_tail);
        mbar_wait(ring.v_empty(st), phase ^ 1);
        mbar_arrive_expect_tx(ring.v_full(st), 2 * T::kTileBytes);
        RT::load(v, &m.vt, ring.v_full(st), t * BK, 0, D, b);
        RT::load(v + T::kTileBytes, &m.vt_lo, ring.v_full(st), t * BK, 0, D, b);
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
    const bool ragged = M % BK != 0;
    const int last_valid = M - (n_tiles - 1) * BK;

    // o_part: one tile's P V, added to o_acc in fp32 (the tensor cores
    // truncate as they accumulate).  l0/l1: this thread's partial row sums.
    float s[BK / 2], o_acc[D / 2], o_part[D / 2];
    uint32_t p_hi[BK / 8][4], p_lo[BK / 8][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, a0 = 0.f, a1 = 0.f, l0 = 0.f, l1 = 0.f;

    // S = Q K^T, both operands K-major.
    auto s_issue = [&](int st) {
      const uint32_t q = opaque(q_s), k = opaque(k_at(st));
      wgmma_3xtf32_ss_fresh<BK, D / 8>(
          s, [&](int kk, int lo) { return R::k_major(q + lo * T::kQBytes, T::kRowsQ, wg * 64, kk); },
          [&](int kk, int lo) { return R::k_major(k + lo * T::kTileBytes, BK, 0, kk); });
    };
    // O part = P V: B is the stage's V^T, K-major over the permuted keys.
    auto pv_issue = [&](int st) {
      const uint32_t vt = opaque(v_at(st));
      wgmma_3xtf32_rs_fresh<D, BK / 8>(o_part, p_hi, p_lo,
                                       [&](int kk, int lo) { return RT::k_major(vt + lo * T::kTileBytes, D, 0, kk); });
    };
    auto fence_pv = [&]() {  // the operands of pv_issue
      fence_regs(o_part);
      fence_regs(p_hi);
      fence_regs(p_lo);
    };
    // O = a O + part, with a the factor of the softmax the part belongs to.
    auto add_part = [&](float f0, float f1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o_acc[4 * j] = fmaf(o_acc[4 * j], f0, o_part[4 * j]);
        o_acc[4 * j + 1] = fmaf(o_acc[4 * j + 1], f0, o_part[4 * j + 1]);
        o_acc[4 * j + 2] = fmaf(o_acc[4 * j + 2], f1, o_part[4 * j + 2]);
        o_acc[4 * j + 3] = fmaf(o_acc[4 * j + 3], f1, o_part[4 * j + 3]);
      }
    };
    auto stage = [](int t) { return t % S; };
    auto parity = [](int t) { return (uint32_t)((t / S) & 1); };

    mbar_wait(q_full, 0);
    // Tile 0.
    mbar_wait(ring.k_full(0), 0);
    fence_regs(s);
    wgmma_fence();
    s_issue(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(ring.k_empty(0));
    softmax_tile_f32<BK>(s, m0, m1, a0, a1, l0, l1, scale_log2, ragged && n_tiles == 1, last_valid, t4);
    to_tf32_frags<BK>(s, p_hi, p_lo);

    // Tile t: issue S(t), then the part P(t-1) V(t-1); the softmax of S(t)
    // runs while that product does, and P(t) is split once it has retired.
    // The last tile takes its own step, so the loop carries no key mask.
    auto step = [&](int t, bool mask) {
      mbar_wait(ring.k_full(stage(t)), parity(t));
      mbar_wait(ring.v_full(stage(t - 1)), parity(t - 1));
      // Turns: warpgroup 0 issues tile t's products, then warpgroup 1 (barrier
      // 1 + wg is this warpgroup's turn, signalled by the other one).
      if (T::kPingPong && !(wg == 0 && t == 1)) named_bar_sync(1 + wg, 256);
      fence_regs(s);
      fence_pv();
      wgmma_fence();
      s_issue(stage(t));
      wgmma_commit();
      pv_issue(stage(t - 1));
      wgmma_commit();
      if (T::kPingPong && !(wg == 1 && t == n_tiles - 1)) named_bar_arrive(2 - wg, 256);
      const float f0 = a0, f1 = a1;  // the factor of tile t - 1, before the softmax of tile t replaces it
      wgmma_wait<1>();  // S(t) is ready; P V of tile t - 1 may still run
      fence_regs(s);
      if (lane == 0) mbar_arrive(ring.k_empty(stage(t)));
      softmax_tile_f32<BK>(s, m0, m1, a0, a1, l0, l1, scale_log2, mask, last_valid, t4);
      wgmma_wait<0>();
      fence_pv();
      if (lane == 0) mbar_arrive(ring.v_empty(stage(t - 1)));
      add_part(f0, f1);
      to_tf32_frags<BK>(s, p_hi, p_lo);
    };
    for (int t = 1; t < n_tiles - 1; ++t) step(t, false);
    if (n_tiles > 1) step(n_tiles - 1, ragged);
    mbar_wait(ring.v_full(stage(n_tiles - 1)), parity(n_tiles - 1));
    fence_pv();
    wgmma_fence();
    pv_issue(stage(n_tiles - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_pv();
    add_part(a0, a1);

    // Epilogue: the row sums from the quad's partials.
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int row_a = q0 + wg * 64 + warp * 16 + g;
    const int row_b = row_a + 8;
    store_rows_f32<D>(o_acc, o + (size_t)b * N * D, row_a, N, 1.f / l0, 1.f / l1, t4);
    if (t4 == 0) {
      if (row_a < N) lse[(size_t)b * N + row_a] = m0 * kLn2 + logf(l0);
      if (row_b < N) lse[(size_t)b * N + row_b] = m1 * kLn2 + logf(l1);
    }
  }
}

// The forms of the bf16 kernel (the C interface's `form`).
enum Form { kTiled = 0, kResident = 1 };

// SMs of the current device, read once per device.
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int N, int M, float scale_log2, int form, cudaStream_t stream) {
  using T = Bf16Tiles<D>;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, B, N, D, T::kBox, T::kRowsQ) || !encode_map(&tk, k, B, M, D, T::kBox, T::kKeys) ||
      !encode_map(&tv, v, B, M, D, T::kBox, T::kKeys)) {
    return cudaErrorInvalidValue;
  }
  if (form == kResident) {
    if constexpr (T::kResidentTiles == 0) {
      return cudaErrorInvalidValue;
    } else {
      const int tiles = (M + T::kKeys - 1) / T::kKeys;
      const long long items = (long long)B * ((N + T::kRowsQ - 1) / T::kRowsQ);
      if (tiles > T::kResidentTiles || items > (1 << 30)) return cudaErrorInvalidValue;
      const int smem = T::resident_smem(tiles);
      static const cudaError_t err =
          allow_smem(flash_fwd_bf16_resident_kernel<D>, T::resident_smem(T::kResidentTiles));  // once per kernel
      if (err != cudaSuccess) return err;
      // One CTA an SM, at most one an item.
      const int sms = sm_count();
      if (sms <= 0) return cudaErrorInvalidDevice;
      const int grid = items < sms ? (int)items : sms;
      flash_fwd_bf16_resident_kernel<D><<<grid, T::kThreads, smem, stream>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, N, M, scale_log2, (int)items);
      return cudaGetLastError();
    }
  }
  if (form != kTiled) return cudaErrorInvalidValue;
  const dim3 grid((N + T::kRowsQ - 1) / T::kRowsQ, B);
  static const cudaError_t err = allow_smem(flash_fwd_bf16_kernel<D>, T::kSmemBytes);  // once per kernel
  if (err != cudaSuccess) return err;
  flash_fwd_bf16_kernel<D><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, N, M, scale_log2);
  return cudaGetLastError();
}

// The fp32 kernel's tensor maps: Q's parts in tiles of the CTA's rows, K's of
// BK rows (each also in tail boxes where D has them), V^T's (rows of M rounded
// up to kTransposePad) of BK columns and D rows.
template <int D>
cudaError_t launch_f32(const void* const* parts, void* o, float* lse, int B, int N, int M, float scale_log2,
                       cudaStream_t stream) {
  using T = F32Tiles<D>;
  using R = typename T::Rows;
  const int box_t = T::RowsT::kBox;
  const int mp = (M + kTransposePad - 1) / kTransposePad * kTransposePad;
  F32Maps m;
  // A D-wide part in boxes of R::kBox columns, and of R::kTailBox where there is a tail.
  auto rows = [&](CUtensorMap* map, CUtensorMap* tail, int part, int n, int box_rows) {
    return encode_map(map, parts[part], B, n, D, R::kBox, box_rows, 4) &&
           (R::kTailBytes == 0 || encode_map(tail, parts[part], B, n, D, R::kTailBox, box_rows, 4));
  };
  if (parts == nullptr || !rows(&m.q, &m.q_tail, kQHi, N, T::kRowsQ) ||
      !rows(&m.q_lo, &m.q_lo_tail, kQLo, N, T::kRowsQ) || !rows(&m.k, &m.k_tail, kKHi, M, T::kKeys) ||
      !rows(&m.k_lo, &m.k_lo_tail, kKLo, M, T::kKeys) ||
      !encode_map(&m.vt, parts[kVt], B, D, mp, box_t, D, 4) ||
      !encode_map(&m.vt_lo, parts[kVtLo], B, D, mp, box_t, D, 4)) {
    return cudaErrorInvalidValue;
  }
  static const cudaError_t err = allow_smem(flash_fwd_f32_kernel<D>, T::kSmemBytes);  // once per kernel
  if (err != cudaSuccess) return err;
  const dim3 grid((N + T::kRowsQ - 1) / T::kRowsQ, B);
  flash_fwd_f32_kernel<D><<<grid, T::kThreads, T::kSmemBytes, stream>>>(m, static_cast<float*>(o), lse, N, M,
                                                                         scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q [B,N,D], k and v [B,M,D], o [B,N,D] (all contiguous, same dtype, 16-byte
// aligned), lse [B,N] fp32.  is_bf16 selects bf16 (1) or fp32 (0); D is 32,
// 64 or 128, and for fp32 also 40; the bf16 kernel takes scale > 0 only.  parts: for fp32, a host
// array of the device pointers of enum Part (made by
// flash_attention.py::tf32_fwd_parts, each contiguous and 16-byte aligned; the
// kernel reads these, not q, k, v); null for bf16.  form: enum Form, the bf16
// kernel's (flash_attention.py::fwd_form chooses it; kResident takes D = 32
// and at most Bf16Tiles<32>::kResidentTiles tiles of keys); 0 for fp32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mrisr_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int N, int M, int D, int is_bf16,
                                    float scale, const void* const* parts, int form, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const float sl2 = scale * kLog2e;
  float* l = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 32: return (int)launch_bf16<32>(q, k, v, o, l, B, N, M, sl2, form, st);
      case 64: return (int)launch_bf16<64>(q, k, v, o, l, B, N, M, sl2, form, st);
      case 128: return (int)launch_bf16<128>(q, k, v, o, l, B, N, M, sl2, form, st);
    }
  } else {
    if (form != kTiled) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 32: return (int)launch_f32<32>(parts, o, l, B, N, M, sl2, st);
      case 40: return (int)launch_f32<40>(parts, o, l, B, N, M, sl2, st);
      case 64: return (int)launch_f32<64>(parts, o, l, B, N, M, sl2, st);
      case 128: return (int)launch_f32<128>(parts, o, l, B, N, M, sl2, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
