// K5 `layernorm_bwd` and `column_sum`: the LayerNorm VJP from the saved
// pre-LN sum, with the cross-row gradient sums, for sm_90a.
//
// Replaces the LN-backward and column-sum parts of `_mlp_ln_bwd_kernel`
// (mvlt_tpu/ops/pallas_attn.py:2931; lines 2970-2991 and 3003) and the LN VJP
// of `_attn_ln_bwd_stored` (:2645-2649). Per row m of the f32 pre-LN sum
// res (M, C), with gamma (C,) f32 and the upstream gradient g (M, C) bf16:
//   xhat = (res - mean) * r,  r = rsqrt(var + eps)   (two-pass moments, as K3)
//   dxhat = g * gamma
//   dres = r * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))   (f32, for the residual path)
//   da   = dres * hmask                  (optional bf16 hidden-dropout mask; da = dres without it)
// with an optional bf16 copy of da (the cotangent of the proj / fc2 output), and
// the column sums over rows
//   dgamma = sum g * xhat,  dbeta = sum g,  db = sum da   (the fc2 / proj bias grad:
//   `da` / `dbproj` at pallas_attn.py:2651,2663 and `dmlp` / `db2` at :2984,2989).
// `column_sum` is the plain column sum of a bf16 or f32 (M, N) matrix (db1 over
// the (M, 3072) fc1 cotangent, dbqkv over dQKV).
//
// Bound: memory. One warp per row holds the row in registers (C / 32 values
// a lane), so res and g are read once and dres written once. The cross-row
// sums are deterministic: each block folds its warps' sums in a fixed order
// into one partial row of a scratch, and a second kernel sums the partials
// column by column. No atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int RPW = 2;  // rows per warp
constexpr int ROWS_PER_BLOCK = WARPS * RPW;

// out[c] = sum over the block's warps, in order, of their acc[c]
template <int CPL>
__device__ __forceinline__ void fold(float (*red)[CPL * 32], const float (&acc)[CPL], float* out, int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < CPL; ++t) red[warp][t * 32 + lane] = acc[t];
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += WARPS * 32) {
    float v = 0.f;
    for (int w = 0; w < WARPS; ++w) v += red[w][c];
    out[c] = v;
  }
  __syncthreads();
}

template <int CPL>
__global__ void __launch_bounds__(WARPS * 32)
ln_bwd_kernel(const float* __restrict__ res, const float* __restrict__ gamma,
              const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ hmask,
              float* __restrict__ dres, __nv_bfloat16* __restrict__ dres_bf, float* __restrict__ part,
              int M, int C, float eps) {
  __shared__ float red[WARPS][CPL * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float invC = 1.0f / (float)C;

  float gam[CPL], acc_g[CPL], acc_b[CPL], acc_d[CPL];
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
    int c = t * 32 + lane;
    gam[t] = c < C ? gamma[c] : 0.f;
    acc_g[t] = acc_b[t] = acc_d[t] = 0.f;
  }

  for (int k = 0; k < RPW; ++k) {
    const int m = blockIdx.x * ROWS_PER_BLOCK + k * WARPS + warp;
    if (m >= M) break;
    const float* rr = res + (size_t)m * C;
    const __nv_bfloat16* gr = g + (size_t)m * C;
    float x[CPL], gv[CPL];
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      int c = t * 32 + lane;
      x[t] = c < C ? rr[c] : 0.f;
      gv[t] = c < C ? __bfloat162float(gr[c]) : 0.f;
      sum += x[t];
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum * invC;
    float sq = 0.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      float d = t * 32 + lane < C ? x[t] - mu : 0.f;
      sq += d * d;
    }
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float r = rsqrtf(sq * invC + eps);
    float sdx = 0.f, sdxx = 0.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      x[t] = (x[t] - mu) * r;  // xhat
      float dxh = gv[t] * gam[t];
      sdx += dxh;
      sdxx += dxh * x[t];
    }
    for (int o = 16; o > 0; o >>= 1) {
      sdx += __shfl_xor_sync(0xffffffffu, sdx, o);
      sdxx += __shfl_xor_sync(0xffffffffu, sdxx, o);
    }
    const float mdx = sdx * invC, mdxx = sdxx * invC;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      int c = t * 32 + lane;
      if (c >= C) continue;
      float d = r * (gv[t] * gam[t] - mdx - x[t] * mdxx);
      dres[(size_t)m * C + c] = d;
      if (hmask) d *= __bfloat162float(hmask[(size_t)m * C + c]);
      if (dres_bf) dres_bf[(size_t)m * C + c] = __float2bfloat16(d);
      acc_g[t] += gv[t] * x[t];
      acc_b[t] += gv[t];
      acc_d[t] += d;
    }
  }

  // fold the warps' sums in a fixed order: one partial row per block and sum
  float* out = part + (size_t)blockIdx.x * 3 * C;
  fold<CPL>(red, acc_g, out, C);
  fold<CPL>(red, acc_b, out + C, C);
  fold<CPL>(red, acc_d, out + 2 * C, C);
}

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

// part[chunk, c] = sum of x[r, c] over the rows of the chunk
template <typename T>
__global__ void colsum_kernel(const T* __restrict__ x, float* __restrict__ part, int M, int N, int rows) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  int r0 = blockIdx.y * rows, r1 = min(M, r0 + rows);
  float v = 0.f;
  for (int r = r0; r < r1; ++r) v += to_f(x[(size_t)r * N + c]);
  part[(size_t)blockIdx.y * N + c] = v;
}

// out[c] = sum over p of part[p, c], in order
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int P, int W) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= W) return;
  float v = 0.f;
  for (int p = 0; p < P; ++p) v += part[(size_t)p * W + c];
  out[c] = v;
}

template <int CPL>
cudaError_t ln_bwd_launch(const float* res, const float* gamma, const __nv_bfloat16* g,
                          const __nv_bfloat16* hmask, float* dres, __nv_bfloat16* dres_bf, float* part, int M,
                          int C, float eps, cudaStream_t s) {
  int blocks = (M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  ln_bwd_kernel<CPL><<<blocks, WARPS * 32, 0, s>>>(res, gamma, g, hmask, dres, dres_bf, part, M, C, eps);
  return cudaGetLastError();
}

}  // namespace

// Scratch rows the caller must provide to mvlt_layernorm_bwd (part: rows x 3C f32).
extern "C" int mvlt_layernorm_bwd_blocks(int M) { return (M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK; }

// sums: (3, C) f32 out = [dgamma; dbeta; db]; hmask and dres_bf may be null.
extern "C" int mvlt_layernorm_bwd(const void* res, const void* gamma, const void* g, const void* hmask,
                                  void* dres, void* dres_bf, void* part, void* sums, int M, int C, float eps,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const float*>(res);
  auto ga = static_cast<const float*>(gamma);
  auto gg = static_cast<const __nv_bfloat16*>(g);
  auto hm = static_cast<const __nv_bfloat16*>(hmask);
  auto d = static_cast<float*>(dres);
  auto db = static_cast<__nv_bfloat16*>(dres_bf);
  auto pt = static_cast<float*>(part);
  cudaError_t e;
  if (C <= 128) e = ln_bwd_launch<4>(r, ga, gg, hm, d, db, pt, M, C, eps, s);
  else if (C <= 256) e = ln_bwd_launch<8>(r, ga, gg, hm, d, db, pt, M, C, eps, s);
  else if (C <= 512) e = ln_bwd_launch<16>(r, ga, gg, hm, d, db, pt, M, C, eps, s);
  else if (C <= 768) e = ln_bwd_launch<24>(r, ga, gg, hm, d, db, pt, M, C, eps, s);
  else if (C <= 1024) e = ln_bwd_launch<32>(r, ga, gg, hm, d, db, pt, M, C, eps, s);
  else return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  int W = 3 * C;
  reduce_kernel<<<(W + 255) / 256, 256, 0, s>>>(pt, static_cast<float*>(sums),
                                                mvlt_layernorm_bwd_blocks(M), W);
  return (int)cudaGetLastError();
}

// Row chunks of `column_sum` for an (M, N) input; part is chunks x N f32.
extern "C" int mvlt_column_sum_chunks(int M, int N) {
  int col_blocks = (N + 255) / 256;
  int chunks = (2 * 132 + col_blocks - 1) / col_blocks;
  return chunks < M ? (chunks > 0 ? chunks : 1) : (M > 0 ? M : 1);
}

extern "C" int mvlt_column_sum(const void* x, int x_f32, void* part, void* out, int M, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int chunks = mvlt_column_sum_chunks(M, N);
  int rows = (M + chunks - 1) / chunks;
  dim3 grid((N + 255) / 256, chunks);
  if (x_f32)
    colsum_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(part), M, N,
                                              rows);
  else
    colsum_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                      static_cast<float*>(part), M, N, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<(N + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part), static_cast<float*>(out),
                                                chunks, N);
  return (int)cudaGetLastError();
}
