// Hopper (sm_90a) building blocks in raw PTX for flash_attn_fwd.cu and
// flash_attn_bwd.cu: mbarriers, TMA tensor loads and the host code that encodes
// their tensor maps, warpgroup matrix multiplies (wgmma, bf16 and tf32) and
// their shared-memory descriptors, register reallocation between warpgroups.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive and add `bytes` to the transaction count that TMA loads will complete.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that lasts
// about four seconds means a lost arrival (a bug): trap, so the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 33)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Make generic-proxy writes to shared memory visible to the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers 1..15 (0 is __syncthreads): `count` threads take part, some
// waiting (sync) and some only signalling (arrive).
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- TMA ------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Copy the box at coordinates (c0 innermost, c1, c2) of a 3-D tensor map into
// shared memory; completion is counted in bytes on `bar`.  Out-of-bounds
// elements are filled with zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- warpgroup registers -------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), and the swizzle mode (1 = 128B, 2 = 64B, 3 = 32B,
// 0 = none).  A swizzled tile's base must be aligned to the swizzle's repeat
// (1024 bytes for 128B, 512 for 64B, 256 for 32B); then the start may step by
// k-offsets inside a row.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, uint32_t swizzle) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin wgmma operand registers in place: the compiler may not move their reads
// or writes across this point.  Called on the accumulators and A fragments
// before wgmma_fence (so no write to them lands inside the wgmma batch, which
// would make ptxas serialize every wgmma of the kernel) and on the
// accumulators after wgmma_wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R, int C>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// `x`, hidden from the optimizer: descriptors built from it are computed where
// a wgmma group is issued instead of hoisted out of the loop into registers
// (with a single ring stage every descriptor of a kernel is loop-invariant,
// and at D=128 the hoisted ones spill).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// Accumulator layout (f32, m64nN): thread `lane` of warp w of the warpgroup
// holds, for each 8-column block j, d[4j + 0..1] at row 16w + lane/4, columns
// 8j + 2(lane%4) + 0..1, and d[4j + 2..3] at row 16w + lane/4 + 8.  The A
// fragment in registers (bf16, k16) is the mma.sync m16n8k16 A fragment of the
// warp's 16 rows: a[0] (row g, k 2t..2t+1), a[1] (row g+8), a[2] (row g,
// k 2t+8..2t+9), a[3] (row g+8, k 2t+8..2t+9), with g = lane/4, t = lane%4.

// D[64 x 32] (+)= A[64 x 16] B[16 x 32]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 8] += A[64 x 16] B[16 x 8]: A in registers (bf16 pairs), B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32]: A in registers (bf16 pairs), B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 40] += A[64 x 16] B[16 x 40]: A in registers (bf16 pairs), B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n40(float (&d)[20], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers (bf16 pairs), B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 72] += A[64 x 16] B[16 x 72]: A in registers (bf16 pairs), B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n72(float (&d)[36], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, {%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A in registers (bf16 pairs), B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32(d, desc_a, desc_b, scale_d);
  if constexpr (N == 64) wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  if constexpr (N == 128) wgmma_ss_n128(d, desc_a, desc_b, scale_d);
  if constexpr (N == 256) wgmma_ss_n256(d, desc_a, desc_b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (N == 8) wgmma_rs_n8(d, a, desc_b);
  if constexpr (N == 32) wgmma_rs_n32(d, a, desc_b);
  if constexpr (N == 40) wgmma_rs_n40(d, a, desc_b);
  if constexpr (N == 64) wgmma_rs_n64(d, a, desc_b);
  if constexpr (N == 72) wgmma_rs_n72(d, a, desc_b);
  if constexpr (N == 128) wgmma_rs_n128(d, a, desc_b);
}

// D[64 x 16] (+)= A[64 x 8] B[8 x 16] in tf32: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_ss_n16(float (&d)[8], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 8] B[8 x 32] in tf32: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 40] (+)= A[64 x 8] B[8 x 40] in tf32: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_ss_n40(float (&d)[20], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, %20, %21, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 8] B[8 x 64] in tf32: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 8] B[8 x 32] in tf32: A in registers, B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 40] (+)= A[64 x 8] B[8 x 40] in tf32: A in registers, B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n40(float (&d)[20], const uint32_t (&a)[4], uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 8] B[8 x 64] in tf32: A in registers, B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 8] B[8 x 128] in tf32: A in registers, B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  if constexpr (N == 16) wgmma_tf32_ss_n16(d, desc_a, desc_b, scale_d);
  if constexpr (N == 32) wgmma_tf32_ss_n32(d, desc_a, desc_b, scale_d);
  if constexpr (N == 40) wgmma_tf32_ss_n40(d, desc_a, desc_b, scale_d);
  if constexpr (N == 64) wgmma_tf32_ss_n64(d, desc_a, desc_b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b,
                                              int scale_d = 1) {
  if constexpr (N == 32) wgmma_tf32_rs_n32(d, a, desc_b, scale_d);
  if constexpr (N == 40) wgmma_tf32_rs_n40(d, a, desc_b, scale_d);
  if constexpr (N == 64) wgmma_tf32_rs_n64(d, a, desc_b, scale_d);
  if constexpr (N == 128) wgmma_tf32_rs_n128(d, a, desc_b, scale_d);
}

// 3xTF32: x = hi + lo, each rounded to tf32 (to nearest, ties away from
// zero), and a b ~ hi hi + hi lo + lo hi.  The tensor cores drop the 13 low
// mantissa bits of a raw fp32 operand (tools/tf32_probe.py checks it on the
// card): a truncated split would bias every product toward zero, so both
// parts are rounded first and reach the tensor cores exact.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// a (+)= lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B), the small terms first:
// 3xTF32 for one k-step, both operands in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_3xtf32_ss(float (&d)[N / 2], uint64_t a_hi, uint64_t a_lo, uint64_t b_hi,
                                                uint64_t b_lo, int scale_d) {
  wgmma_tf32_ss<N>(d, a_lo, b_hi, scale_d);
  wgmma_tf32_ss<N>(d, a_hi, b_lo, 1);
  wgmma_tf32_ss<N>(d, a_hi, b_hi, 1);
}

// The same with A in registers (to_tf32_frags).
template <int N>
__device__ __forceinline__ void wgmma_3xtf32_rs(float (&d)[N / 2], const uint32_t (&a_hi)[4],
                                                const uint32_t (&a_lo)[4], uint64_t b_hi, uint64_t b_lo,
                                                int scale_d) {
  wgmma_tf32_rs<N>(d, a_lo, b_hi, scale_d);
  wgmma_tf32_rs<N>(d, a_hi, b_lo);
  wgmma_tf32_rs<N>(d, a_hi, b_hi);
}

// 3xTF32 of a product over K k-steps into a fresh accumulator: the small
// terms of every k-step (lo(A) hi(B), then hi(A) lo(B)) first, the large
// ones (hi(A) hi(B)) last.  The tensor cores truncate each sum they add to
// the accumulator, so a term added to a large accumulator loses up to its
// last bit: with the small terms of each k-step added after the large ones
// of the k-steps before, scores near -130 came out 1e-4 high.  a(kk, part)
// and b(kk, part) give k-step kk's descriptor of the high (part 0) or low
// (part 1) tile.
template <int N, int K, class DescA, class DescB>
__device__ __forceinline__ void wgmma_3xtf32_ss_fresh(float (&d)[N / 2], DescA a, DescB b) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) wgmma_tf32_ss<N>(d, a(kk, 1), b(kk, 0), kk > 0);
#pragma unroll
  for (int kk = 0; kk < K; ++kk) wgmma_tf32_ss<N>(d, a(kk, 0), b(kk, 1), 1);
#pragma unroll
  for (int kk = 0; kk < K; ++kk) wgmma_tf32_ss<N>(d, a(kk, 0), b(kk, 0), 1);
}

// The same with A in registers (to_tf32_frags).
template <int N, int K, class DescB>
__device__ __forceinline__ void wgmma_3xtf32_rs_fresh(float (&d)[N / 2], const uint32_t (&a_hi)[K][4],
                                                      const uint32_t (&a_lo)[K][4], DescB b) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) wgmma_tf32_rs<N>(d, a_lo[kk], b(kk, 0), kk > 0);
#pragma unroll
  for (int kk = 0; kk < K; ++kk) wgmma_tf32_rs<N>(d, a_hi[kk], b(kk, 1), 1);
#pragma unroll
  for (int kk = 0; kk < K; ++kk) wgmma_tf32_rs<N>(d, a_hi[kk], b(kk, 0), 1);
}

// acc += part, element by element, in fp32 (rounded to nearest): the tensor
// cores truncate as they accumulate, which over thousands of k-steps biases
// a sum by ~1e-4, so a long sum takes each tile's product from a fresh
// accumulator.
template <int R>
__device__ __forceinline__ void add_to(float (&acc)[R], const float (&part)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += part[i];
}

// An m64nN fp32 accumulator as the split tf32 A fragments of a product over
// its N columns.  The k8 A fragment of a thread holds (row g, k t), (row g+8,
// k t), (row g, k t+4), (row g+8, k t+4); the accumulator holds columns 2t
// and 2t+1 of each 8-column block.  So n-block j is k-step j with its
// reduction index permuted: column 2t at position t, 2t+1 at t+4.  The B
// operand of the product must be permuted the same way (the transposed copies
// that flash_attention_bwd writes).
template <int N>
__device__ __forceinline__ void to_tf32_frags(const float (&s)[N / 2], uint32_t (&hi)[N / 8][4],
                                              uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    tf32_split(s[4 * j], hi[j][0], lo[j][0]);      // row g, column 2t
    tf32_split(s[4 * j + 2], hi[j][1], lo[j][1]);  // row g + 8, column 2t
    tf32_split(s[4 * j + 1], hi[j][2], lo[j][2]);  // row g, column 2t + 1
    tf32_split(s[4 * j + 3], hi[j][3], lo[j][3]);  // row g + 8, column 2t + 1
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An m64nN accumulator in bf16 as the A fragments of a product over its N
// columns: adjacent accumulator pairs are adjacent columns, so n-blocks 2kk
// and 2kk+1 are k-step kk.
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&s)[N / 2], uint32_t (&p)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * kk + h;
      p[kk][2 * h] = pack_bf16(s[4 * j], s[4 * j + 1]);
      p[kk][2 * h + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Tiles of rows of C elements of E bytes (bf16: E = 2, fp32: E = 4) as TMA
// writes them: boxes of up to 128 bytes a row (128B swizzle; a 64-byte row
// takes the 64B swizzle), one box after the other.  bf16 tiles are one box
// of D columns at D=32 (64-byte rows) and 64 (128), two of 64 at D=128; fp32
// tiles are boxes of 32 columns, or one of 16.  A row of 160 bytes (fp32,
// D=40) is one 128-byte box and a tail box of 8 columns (32 bytes, 32B
// swizzle), read through a second tensor map: a TMA box may not be wider than
// its swizzle span, and 160 is no multiple of 128.  A tile's base is 1024-byte
// aligned.  A wgmma k-step is 32 bytes of a row: 16 bf16 or 8 tf32 columns, so
// the tail box is exactly one tf32 k-step.
template <int C, int E = 2>
struct SwizzledRows {
  static constexpr int kRowBytes = C * E < 128 ? C * E : 128;  // bytes per row of a box: 64 or 128
  static constexpr int kBox = kRowBytes / E;                   // columns per TMA box
  static constexpr int kBoxes = C * E / kRowBytes;             // full boxes
  static constexpr int kTailBytes = C * E % kRowBytes;         // bytes per row of the tail box: 0 or 32
  static constexpr int kTailBox = kTailBytes / E;              // columns of the tail box
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 1 : 2;  // descriptor: 128B or 64B
  static constexpr int kSbo = 8 * kRowBytes;                   // bytes between 8-row groups of a box
  static_assert((kRowBytes == 64 || kRowBytes == 128) && (kTailBytes == 0 || kTailBytes == 32), "tile width");

  // K-major operand (the product sums over the C columns): rows row0.. of a
  // tile of `rows` rows, k-step kk.  kk is a constant after unrolling, so the
  // tail's branch is resolved at compile time.
  __device__ static __forceinline__ uint64_t k_major(uint32_t tile, int rows, int row0, int kk) {
    if (kTailBytes != 0 && kk * 32 >= kBoxes * kRowBytes) {  // the tail box: 32-byte rows, 32B swizzle (3)
      return make_desc(tile + kBoxes * rows * kRowBytes + row0 * kTailBytes, 16, 8 * kTailBytes, 3);
    }
    const int x = kk * 32 / kRowBytes, col = kk * 32 % kRowBytes;
    return make_desc(tile + x * rows * kRowBytes + row0 * kRowBytes + col, 16, kSbo, kSwizzle);
  }

  // MN-major B operand (bf16; the product sums over rows, its N is C; wgmma's
  // transpose bit): k-step kk is rows 16kk..16kk+15 of a tile of `rows` rows,
  // its boxes `rows * kRowBytes` apart (the leading byte offset).
  __device__ static __forceinline__ uint64_t mn_major(uint32_t tile, int rows, int kk) {
    static_assert(kTailBytes == 0, "MN-major tiles have no tail box");
    return make_desc(tile + kk * 16 * kRowBytes, rows * kRowBytes, kSbo, kSwizzle);
  }

  // TMA: rows row0.. (rows of them) and columns col0.. of a [batch, *, *] map
  // into `tile`; the tail box, where there is one, through the map `tail`
  // (the same tensor in boxes of kTailBox columns).
  __device__ static __forceinline__ void load(uint32_t tile, const CUtensorMap* map, uint32_t bar, int col0,
                                              int row0, int rows, int b, const CUtensorMap* tail = nullptr) {
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) tma_load_3d(tile + x * rows * kRowBytes, map, bar, col0 + x * kBox, row0, b);
    if constexpr (kTailBytes != 0) {
      tma_load_3d(tile + kBoxes * rows * kRowBytes, tail, bar, col0 + kBoxes * kBox, row0, b);
    }
  }
};

// The K/V ring of a kernel that walks K and V tiles (the forward, dQ): S
// stages, the mbarriers at `base` after one barrier of the kernel's own, a
// full and an empty barrier for K, then for V, per stage.
template <int S>
struct KvRing {
  uint32_t base;
  __device__ uint32_t k_full(int st) const { return base + 8 * (1 + st); }
  __device__ uint32_t k_empty(int st) const { return base + 8 * (1 + S + st); }
  __device__ uint32_t v_full(int st) const { return base + 8 * (1 + 2 * S + st); }
  __device__ uint32_t v_empty(int st) const { return base + 8 * (1 + 3 * S + st); }
  static constexpr int kBarBytes = 8 * 4 * S;

  // A full barrier waits for the producer's arrival and its TMA bytes, an
  // empty one for lane 0 of each consumer warp.
  __device__ void init(int consumer_warps) const {
    for (int st = 0; st < S; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), consumer_warps);
      mbar_init(v_empty(st), consumer_warps);
    }
  }

  // The producer (one thread): K and V tile t (T::kKeys rows) into stage
  // t % S of the rings at k_s and v_s (T::kTileBytes each; V stages
  // v_stage bytes apart, 0 for T::kTileBytes) once the consumers have
  // released it.
  template <class T>
  __device__ void produce(uint32_t k_s, uint32_t v_s, const CUtensorMap* tk, const CUtensorMap* tv, int n_tiles,
                          int b, int v_stage = 0) const {
    if (v_stage == 0) v_stage = T::kTileBytes;
    constexpr int BK = T::kKeys;
    int st = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_tiles; ++t) {
      mbar_wait(k_empty(st), phase ^ 1);
      mbar_arrive_expect_tx(k_full(st), T::kTileBytes);
#pragma unroll
      for (int x = 0; x < T::kBoxes; ++x) {
        tma_load_3d(k_s + st * T::kTileBytes + x * BK * T::kRowBytes, tk, k_full(st), x * T::kBox, t * BK, b);
      }
      mbar_wait(v_empty(st), phase ^ 1);
      mbar_arrive_expect_tx(v_full(st), T::kTileBytes);
#pragma unroll
      for (int x = 0; x < T::kBoxes; ++x) {
        tma_load_3d(v_s + st * v_stage + x * BK * T::kRowBytes, tv, v_full(st), x * T::kBox, t * BK, b);
      }
      if (++st == S) {
        st = 0;
        phase ^= 1;
      }
    }
  }
};

// Store this thread's two rows of an m64nD fp32 accumulator (row_a and
// row_a + 8, wgmma layout) as bf16 into the row-major [rows, D] `out`, times
// f_a and f_b; rows >= limit are not stored.
template <int D>
__device__ __forceinline__ void store_rows_bf16(const float (&acc)[D / 2], __nv_bfloat16* out, int row_a,
                                                int limit, float f_a, float f_b, int t4) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    if (row_a < limit) {
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row_a * D + col) =
          __floats2bfloat162_rn(acc[4 * j] * f_a, acc[4 * j + 1] * f_a);
    }
    if (row_a + 8 < limit) {
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row_a + 8) * D + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * f_b, acc[4 * j + 3] * f_b);
    }
  }
}

// Store this thread's two rows of an m64nD fp32 accumulator (row_a and
// row_a + 8, wgmma layout) into the row-major fp32 `out` (LD columns a row,
// D of them stored), times f_a and f_b; rows >= limit are not stored.
template <int D, int LD = D>
__device__ __forceinline__ void store_rows_f32(const float (&acc)[D / 2], float* out, int row_a, int limit, float f_a,
                                               float f_b, int t4) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    if (row_a < limit) {
      *reinterpret_cast<float2*>(out + (size_t)row_a * LD + col) = make_float2(acc[4 * j] * f_a, acc[4 * j + 1] * f_a);
    }
    if (row_a + 8 < limit) {
      *reinterpret_cast<float2*>(out + (size_t)(row_a + 8) * LD + col) =
          make_float2(acc[4 * j + 2] * f_b, acc[4 * j + 3] * f_b);
    }
  }
}

// ---- host: TMA tensor maps ------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: fetched once through the
// runtime, so the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 3-D map over a contiguous [batch, rows, cols] tensor of bf16 (elem_bytes
// 2) or fp32 (4), read in boxes of box_rows x box_cols (box_cols * elem_bytes
// is the swizzle width, 32, 64 or 128 bytes).  The zero fill past the last row
// (and column) happens per batch.
bool encode_map(CUtensorMap* map, const void* ptr, int batch, int rows, int cols, int box_cols, int box_rows,
                int elem_bytes = 2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem_bytes, (cuuint64_t)rows * cols * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const int box_bytes = box_cols * elem_bytes;
  const CUtensorMapSwizzle swizzle = box_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType type = elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
