// Hopper building blocks shared by the port's kernels (sm_90a), as inline PTX:
// shared-memory addresses, mbarriers, TMA tile loads, cp.async copies and
// the swizzled-row loaders of K2 and K4, the wgmma shared-memory matrix
// descriptor, and the wgmma products the kernels issue. K1 (gemm.cu) runs a
// TMA + mbarrier ring into m64n128k16 products; K2 (attention.cu) and K4
// (attention_bwd.cu) load with cp.async and run m64n32k16 (S = Q K^T and
// dP = dO V^T, both operands in shared memory) and m64n{32,64}k16 with A in
// registers (P V; dQ = dS K, dV = P^T dO, dK = dS^T Q).
//
// Fragment layouts (PTX ISA, "wgmma .m64nNk16"): thread t of the warpgroup,
// warp w = t / 32, lane l; its rows are r = 16 w + l / 4 and r + 8.
//   accumulator D (f32): d[4 b + 2 hh + e] is row r + 8 hh, column
//     8 b + 2 (l % 4) + e, for each 8-column block b;
//   A from registers (bf16 pairs, low half the lower column): a[0] row r,
//     columns 2 (l % 4) + {0, 1}; a[1] row r + 8, the same columns; a[2]
//     row r, those columns + 8; a[3] row r + 8, columns + 8.
// So the accumulator of one 16-column block pair of a product is, rounded
// to bf16 pairs in order, the A operand of the next product's k16 step.

#pragma once

#include <cuda.h>  // CUtensorMap only: the encoder is fetched from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mvlt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA -----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of the given parity has completed; a wait that never
// ends (a lost TMA transfer) traps, so the launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (tries == (1u << 26)) __trap();
  }
}

// box of the 2-D tensor map at (inner c0, outer c1) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- cp.async ----------------------------------------------------------------

// 16 bytes into shared memory: the first `bytes` (0-16) from global memory,
// the rest zeros (src is not read when bytes is 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's shared-memory writes (cp.async, st.shared) visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- swizzled operand tiles (K2, K4) ----------------------------------------

// threads of one warpgroup, the block of K2's and K4's kernels
constexpr int WARPGROUP = 128;

// byte offset of 16-byte chunk c of row r in a region of ROWB-byte rows that
// starts on a 1024-byte boundary, under the ROWB-byte swizzle
template <int ROWB>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * ROWB + ((c ^ ((r * ROWB >> 7) & (ROWB / 16 - 1))) << 4);
}

// rows first .. first + rows - 1 of one operand into swizzled shared memory;
// rows past N and columns past Dh arrive as zeros
template <int ROWB>
__device__ __forceinline__ void load_rows(unsigned char* dst, const __nv_bfloat16* src, long long base, long long ld,
                                          int first, int rows, int N, int Dh) {
  constexpr int CH = ROWB / 16;
  for (int e = threadIdx.x; e < rows * CH; e += WARPGROUP) {
    const int r = e / CH, c = e % CH;
    const int n = first + r;
    const bool ok = n < N && c * 8 < Dh;
    cp_async16(dst + swz<ROWB>(r, c), ok ? src + base + n * ld + c * 8 : src, ok ? 16 : 0);
  }
}

// the bytes [lo, hi) of device memory (in a tensor that starts on a 16-byte
// boundary) into dst, as the 16-byte chunks that cover them: the first from
// the aligned address at or before lo, the last cut at hi. Returns that
// aligned address: byte b sits at dst + (b - it).
__device__ __forceinline__ uintptr_t stage_span(unsigned char* dst, uintptr_t lo, uintptr_t hi) {
  const uintptr_t start = lo & ~static_cast<uintptr_t>(15);
  for (uintptr_t k = threadIdx.x * 16; start + k < hi; k += WARPGROUP * 16)
    cp_async16(dst + k, reinterpret_cast<const void*>(start + k),
               static_cast<uint32_t>(hi - (start + k) < 16 ? hi - (start + k) : 16));
  return start;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// ---- wgmma -------------------------------------------------------------------

// swizzle modes of the matrix descriptor (bits 62-63)
constexpr uint64_t SWIZZLE_128B = 1, SWIZZLE_64B = 2;

// wgmma shared-memory matrix descriptor. With a B-byte swizzle the rows of
// an operand are B bytes (the swizzle XORs the 16-byte chunk index of an
// address with its bits 7 and up, repeating every 8 rows). K-major: rows of
// k, 8-row groups SBO bytes apart, LBO unused. MN-major: k-rows of m (or n),
// 8-k-row groups SBO bytes apart, B-byte-wide column blocks LBO bytes apart.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle = SWIZZLE_128B) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
  d |= swizzle << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator (or register-operand) reads or
// writes across a wgmma wait or fence (the asm of the wait does not name the
// registers)
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// D (64 x 128, f32) += A (64 x 16) . B (16 x 128) from shared memory; TA / TB
// set: that operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 32, f32) += A (64 x 16) . B (16 x 32), both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 32, f32) += A (64 x 16, bf16 pairs in registers) . B (16 x 32),
// B MN-major in shared memory (its n contiguous: the transpose bit)
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) . B (16 x 64),
// B MN-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

}  // namespace mvlt
