// K1 `gemm`: Y[sidx[m]] = epilogue(A[m, :] . W[n, :] + b[n]) in bf16 with an
// f32 accumulator, for sm_90a.
//
// Replaces the matrix products inside the TPU kernels of
// mvlt_tpu/ops/pallas_attn.py (`_full_body` qkv / proj / fc1 / fc2,
// `_block_kernel`, `_attn_ln_kernel`, `_mlp_ln_kernel`, `_mlp_preln_kernel`).
// A is (M, K) row-major, W is (N, K) row-major (the PyTorch Linear layout), so
// both operands are K-contiguous and feed `mma.sync.m16n8k16.row.col` straight
// from `ldmatrix` with no transpose.
//
// Epilogue, in f32 before the one bf16 rounding:
//   + bias[n]                       (optional)
//   exact erf GELU                  (optional)
//   + R[ridx ? ridx[m] : m, n]      (optional residual, optional row gather)
//   store to row sidx ? sidx[m] : m (optional row scatter)
//
// Bound: at the flagship shapes (K, N <= 3072, M up to 25088) these products
// are compute-bound in principle (up to ~1000 flop per byte). This first
// version is a plain tiled tensor-core GEMM: a 3-stage cp.async ring of
// (BM x 32) and (128 x 32) tiles in padded shared memory, 8 warps each owning
// a 32 x (BN / warps_n) sub-tile. No wgmma/TMA yet: that is later work.
// Ragged M, N and K are masked at 16-byte granularity (K % 8 == 0 and
// N % 8 == 0 are required and checked by the caller).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int LDS = BK + 8;  // padded smem row: 80 bytes, conflict-free ldmatrix
constexpr int THREADS = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3,
                                            const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
            const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ R,
            const int* __restrict__ ridx, const int* __restrict__ sidx,
            __nv_bfloat16* __restrict__ Y, int M, int N, int K, int gelu) {
  constexpr int WARPS_M = BM / 32;
  constexpr int WARPS_N = (THREADS / 32) / WARPS_M;
  constexpr int WN = BN / WARPS_N;  // columns per warp
  constexpr int NT = WN / 8;        // n8 tiles per warp
  static_assert(NT % 2 == 0, "ldmatrix.x4 loads two n8 tiles at a time");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + STAGES * BM * LDS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % WARPS_M;
  const int wn = warp / WARPS_M;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    // A: BM rows x 4 chunks of 8 bf16
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      int r = c >> 2, kc = (c & 3) * 8;
      int gm = m0 + r, gk = k0 + kc;
      bool ok = gm < M && gk < K;
      const __nv_bfloat16* src = ok ? A + (size_t)gm * K + gk : A;
      cp_async16(As + (stage * BM + r) * LDS + kc, src, ok);
    }
    for (int c = tid; c < BN * (BK / 8); c += THREADS) {
      int r = c >> 2, kc = (c & 3) * 8;
      int gn = n0 + r, gk = k0 + kc;
      bool ok = gn < N && gk < K;
      const __nv_bfloat16* src = ok ? W + (size_t)gn * K + gk : W;
      cp_async16(Bs + (stage * BN + r) * LDS + kc, src, ok);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      int nk = kt + STAGES - 1;
      if (nk < ktiles) load_tile(nk % STAGES, nk);
      cp_async_commit();
    }
    const __nv_bfloat16* a_s = As + (kt % STAGES) * BM * LDS;
    const __nv_bfloat16* b_s = Bs + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int row = wm * 32 + i * 16 + (lane & 15);
        int col = kk + (lane >> 4) * 8;
        ldmatrix_x4(af[i][0], af[i][1], af[i][2], af[i][3], a_s + row * LDS + col);
      }
      unsigned bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        int nrow = wn * WN + j * 8 + (lane & 7) + ((lane >> 4) << 3);
        int col = kk + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(bf[j][0], bf[j][1], bf[j + 1][0], bf[j + 1][1], b_s + nrow * LDS + col);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: accumulator (i, j, e) holds row lane/4 (+8 for e >= 2) and
  // columns 2*(lane%4) + {0, 1} of its 16 x 8 tile
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int m = m0 + wm * 32 + i * 16 + (lane >> 2) + half * 8;
      if (m >= M) continue;
      int rrow = R ? (ridx ? ridx[m] : m) : 0;
      int orow = sidx ? sidx[m] : m;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        int n = n0 + wn * WN + j * 8 + (lane & 3) * 2;
        if (n >= N) continue;
        float v0 = acc[i][j][half * 2 + 0];
        float v1 = acc[i][j][half * 2 + 1];
        if (bias) {
          v0 += __bfloat162float(bias[n]);
          v1 += __bfloat162float(bias[n + 1]);
        }
        if (gelu) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        if (R) {
          __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(R + (size_t)rrow * N + n);
          v0 += __bfloat162float(r.x);
          v1 += __bfloat162float(r.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(Y + (size_t)orow * N + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int BM>
cudaError_t launch(const void* A, const void* W, const void* bias, const void* R, const int* ridx,
                   const int* sidx, void* Y, int M, int N, int K, int gelu, cudaStream_t stream) {
  const int smem = STAGES * (BM + BN) * LDS * (int)sizeof(__nv_bfloat16);
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(gemm_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<BM><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(W),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(R), ridx, sidx,
      static_cast<__nv_bfloat16*>(Y), M, N, K, gelu);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mvlt_gemm(const void* A, const void* W, const void* bias, const void* R, const void* ridx,
                         const void* sidx, void* Y, int M, int N, int K, int gelu, void* stream) {
  const int* ri = static_cast<const int*>(ridx);
  const int* si = static_cast<const int*>(sidx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 128-row tiles when they already give the card's 132 SMs a full wave,
  // 64-row tiles otherwise (e.g. BERT's M = 592).
  long tiles128 = (long)((M + 127) / 128) * ((N + BN - 1) / BN);
  if (tiles128 >= 132) return (int)launch<128>(A, W, bias, R, ri, si, Y, M, N, K, gelu, s);
  return (int)launch<64>(A, W, bias, R, ri, si, Y, M, N, K, gelu, s);
}
