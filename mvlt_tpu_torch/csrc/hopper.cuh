// Hopper building blocks shared by the port's kernels (sm_90a), as inline PTX:
// shared-memory addresses, mbarriers, TMA tile loads and the host's tensor-map
// encoder, cp.async copies and the swizzled-row loaders of K2 and K4, the
// staging of bias tiles beside a TMA ring, warp specialisation (register
// hand-over, named barriers), the wgmma shared-memory matrix descriptor, and
// the wgmma products the kernels issue. K1 (gemm.cu) and the long forms of K2
// (attention.cu) and K4 (attention_bwd.cu) run a TMA + mbarrier ring kept
// full by a producer warpgroup; the register forms of K2 and K4 load with
// cp.async. The products: m64n128k16 (K1), m64n32k16 (S = Q K^T and dP = dO
// V^T, both operands in shared memory) and m64n{32,64}k16 with A in
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

// box of the 4-D tensor map at (c0, c1, c2, c3), innermost first
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled through the runtime, so a library
// needs no link against libcuda
inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(ptr)
                                                                  : nullptr;
  }();
  return fn;
}

// A 4-D tensor map of the bf16 rows of one operand of attention: element (d,
// h, n, g) at base + h * sh + n * sn + g * sg (element strides; sh, sn, sg
// multiples of 8, base 16-byte aligned), dims (Dh, heads, N, G), read in
// boxes of cols x 1 x rows x 1 with the (2 cols)-byte swizzle (cols 32 or
// 64). Elements past Dh (the head dims 16 and 48 padded to a swizzle row) and
// rows past N arrive as zeros.
inline bool head_rows_map(CUtensorMap* map, const void* base, int Dh, int heads, int N, int G, long long sh,
                          long long sn, long long sg, int cols, int rows) {
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)heads, (cuuint64_t)N, (cuuint64_t)G};
  cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sn * 2, (cuuint64_t)sg * 2};
  cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- warp specialisation ----------------------------------------------------

// hand registers from the producer warpgroup to the consumers (every thread
// of the warpgroup executes it)
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a consumer warp is done with a ring stage: lane 0 arrives on its `empty`
// barrier once every lane is past its reads
__device__ __forceinline__ void release_stage(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
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
// one arrival on the mbarrier once every cp.async this thread issued so far
// has landed (counted in the barrier's arrival count: no increment)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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

// ---- bias tiles beside a TMA ring (K2's and K4's long form) ------------------

// The elements (r, c) with r < rlim and c < clim of a rows x cols tile of a
// row-major matrix (element (r, c), E bytes, at src + r * ld + c * E bytes)
// into shared memory (row r at dst + r * dld bytes), by thread t of nt:
// U-byte cp.async (U = 4 or 8; src, ld and clim * E multiples of U), or with
// U == E (a bf16 matrix whose rows start 2 bytes off 4) plain loads and
// stores. A thread keeps one column and walks the rows nt / (units a row)
// apart (the units of a row divide nt). Elements past the limits are not
// written: no reader takes them.
template <int E, int U>
__device__ __forceinline__ void stage_tile(unsigned char* dst, int dld, const unsigned char* src, long long ld,
                                           int rows, int cols, int rlim, int clim, int t, int nt) {
  constexpr int EPU = U / E;
  const int upr = cols / EPU, step = nt / upr;
  const int r0 = t / upr, c = (t - r0 * upr) * EPU;
  if (c >= clim) return;
  const int rend = rows < rlim ? rows : rlim;
  const unsigned char* s = src + r0 * ld + c * E;
  uint32_t d = smem_u32(dst) + r0 * dld + c * E;
  const long long sstep = step * ld;
#pragma unroll 4
  for (int r = r0; r < rend; r += step, s += sstep, d += step * dld) {
    if constexpr (U >= 4)
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(s), "n"(U) : "memory");
    else
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(d),
                   "h"(__ldg(reinterpret_cast<const unsigned short*>(s)))
                   : "memory");
  }
}
// stage_tile with the unit chosen at run time (`stage_unit` on the host)
template <int E>
__device__ __forceinline__ void stage_tile_any(int unit, unsigned char* dst, int dld, const unsigned char* src,
                                               long long ld, int rows, int cols, int rlim, int clim, int t,
                                               int nt) {
  if (unit == 8)
    stage_tile<E, 8>(dst, dld, src, ld, rows, cols, rlim, clim, t, nt);
  else if (unit == 4 || E == 4)
    stage_tile<E, 4>(dst, dld, src, ld, rows, cols, rlim, clim, t, nt);
  else
    stage_tile<E, E>(dst, dld, src, ld, rows, cols, rlim, clim, t, nt);
}
// The middle forms' bias tiles: the first `bytes` bytes of each row r <
// min(rows, rlim) of a row-major matrix (row r at src + r * ld bytes) into
// dst + r * dld, as the 16-byte chunks that cover them from the 16-byte
// boundary at or before the row's start, the last cut at the row's end: the
// row's byte b lands at dst + r * dld + (src + r * ld) % 16 + b. At most CH
// chunks a row (dld >= 16 CH), by thread t of nt. The matrix starts on a
// 16-byte boundary, so every chunk lies in it; rows of any length and start
// take 16-byte cp.async (where 4-byte units, or 2-byte plain copies at an
// odd N of bf16, are all `stage_tile` can take).
template <int CH>
__device__ __forceinline__ void stage_rows16(unsigned char* dst, int dld, const unsigned char* src, long long ld,
                                             int bytes, int rows, int rlim, int t, int nt) {
  const int rend = rows < rlim ? rows : rlim;
  for (int e = t; e < rend * CH; e += nt) {
    const int r = e / CH, k = e - r * CH;
    const uintptr_t s = reinterpret_cast<uintptr_t>(src + r * ld), end = s + bytes;
    const uintptr_t a = (s & ~static_cast<uintptr_t>(15)) + 16 * k;
    if (a < end)
      cp_async16(dst + r * dld + 16 * k, reinterpret_cast<const void*>(a),
                 static_cast<uint32_t>(end - a < 16 ? end - a : 16));
  }
}
// where element e of a matrix of E-byte elements starts, mod 16: the shift
// of its row in a tile `stage_rows16` staged (0 for an absent matrix)
template <typename T>
__device__ __forceinline__ int row_shift(const T* base, size_t e, int E) {
  return base ? static_cast<int>((reinterpret_cast<uintptr_t>(base) + e * E) & 15) : 0;
}
// ask for the 16-byte-aligned bytes inside [lo, lo + bytes) to be brought
// into L2 ahead of their use (a bulk prefetch: no shared memory, no
// barrier), in pieces of 16 KB
__device__ __forceinline__ void prefetch_l2(const void* lo, size_t bytes) {
  const uintptr_t a = (reinterpret_cast<uintptr_t>(lo) + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t end = (reinterpret_cast<uintptr_t>(lo) + bytes) & ~static_cast<uintptr_t>(15);
  for (uintptr_t x = a; x < end; x += 16384) {
    const uint32_t n = static_cast<uint32_t>(end - x < 16384 ? end - x : 16384);
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(x), "r"(n) : "memory");
  }
}
// a producer thread's two arrivals on a stage's `full` barrier (counted as
// two per producer thread): one now, which releases its plain stores, and
// one once every cp.async it issued has landed
__device__ __forceinline__ void stage_arrive(uint64_t* bar) {
  mbar_arrive(bar);
  cp_async_arrive(bar);
}
// the widest cp.async unit (8 or 4 bytes) that every row of a row-major
// matrix of E-byte elements, ld elements a row, at p meets; E where none does
inline int stage_unit(const void* p, long long ld, int E) {
  const unsigned long long a = reinterpret_cast<uintptr_t>(p) | static_cast<unsigned long long>(ld * E);
  return a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : E;
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

// d (64 x 32, f32) = A B^T over DP (32 or 64) head columns: A 64 rows and B
// 32 rows of the (2 DP)-byte swizzled K-major layout at a / b; one commit
// group left in flight (the long forms' S = Q K^T, dP = dO V^T, and their
// transposes). d is zeroed first.
template <int DP>
__device__ __forceinline__ void wgmma_rows32(float (&d)[16], uint32_t a, uint32_t b) {
  constexpr uint64_t SW = DP == 64 ? SWIZZLE_128B : SWIZZLE_64B;
  constexpr uint32_t SBO = 8 * DP * 2;
#pragma unroll
  for (int x = 0; x < 16; ++x) d[x] = 0.f;
  fence_acc(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_m64n32k16(d, make_desc(a + kk * 32, 16, SBO, SW), make_desc(b + kk * 32, 16, SBO, SW));
  wgmma_commit();
  fence_acc(d);
}

// two such products in one commit group (K4's S and dP of one chunk)
template <int DP>
__device__ __forceinline__ void wgmma_rows32_pair(float (&d0)[16], uint32_t a0, uint32_t b0, float (&d1)[16],
                                                  uint32_t a1, uint32_t b1) {
  constexpr uint64_t SW = DP == 64 ? SWIZZLE_128B : SWIZZLE_64B;
  constexpr uint32_t SBO = 8 * DP * 2;
#pragma unroll
  for (int x = 0; x < 16; ++x) d0[x] = d1[x] = 0.f;
  fence_acc(d0);
  fence_acc(d1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    wgmma_m64n32k16(d0, make_desc(a0 + kk * 32, 16, SBO, SW), make_desc(b0 + kk * 32, 16, SBO, SW));
    wgmma_m64n32k16(d1, make_desc(a1 + kk * 32, 16, SBO, SW), make_desc(b1 + kk * 32, 16, SBO, SW));
  }
  wgmma_commit();
  fence_acc(d0);
  fence_acc(d1);
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
