// K3 `layernorm`: y[m] = LN(x[gidx ? gidx[m] : m]) * gamma + beta over rows of
// C channels, bf16 or f32 in (f32: the pre-LN sum of the training forward),
// bf16 out, f32 statistics and f32 gamma / beta, for sm_90a.
//
// Replaces the row LayerNorms inside the TPU kernels of
// mvlt_tpu/ops/pallas_attn.py (`_ln` in `_full_body`, `_attn_ln_kernel`,
// `_mlp_ln_kernel`, `_mlp_preln_kernel`, and the XLA LN1 around
// `_block_kernel`). It holds the exact two-pass moments of their interpret
// path (mean, then the mean of squared deviations), not the TPU fast path's
// ones-matvec E[x^2] - E[x]^2. The optional row gather is the SW-MSA cyclic
// shift: LN1 reads the shifted window layout straight from the unshifted one.
//
// Bound: memory (one read of x, one write of y: ~4 flop per byte). One warp
// per row; the three passes over a row (at most 6 KB) re-read it from L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
layernorm_kernel(const T* __restrict__ x, const int* __restrict__ gidx,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 __nv_bfloat16* __restrict__ y, int M, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (m >= M) return;
  const int src = gidx ? gidx[m] : m;
  const T* xr = x + (size_t)src * C;

  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += to_f(xr[c]);
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mu = sum / (float)C;
  float sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    float d = to_f(xr[c]) - mu;
    sq += d * d;
  }
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq / (float)C + eps);
  __nv_bfloat16* yr = y + (size_t)m * C;
  for (int c = lane; c < C; c += 32)
    yr[c] = __float2bfloat16((to_f(xr[c]) - mu) * rstd * gamma[c] + beta[c]);
}

}  // namespace

extern "C" int mvlt_layernorm(const void* x, const void* gidx, const void* gamma, const void* beta, void* y,
                              int M, int C, float eps, int x_f32, void* stream) {
  dim3 grid((M + WARPS - 1) / WARPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gi = static_cast<const int*>(gidx);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(y);
  if (x_f32)
    layernorm_kernel<float><<<grid, WARPS * 32, 0, s>>>(static_cast<const float*>(x), gi, g, b, out, M, C, eps);
  else
    layernorm_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, s>>>(static_cast<const __nv_bfloat16*>(x), gi, g, b,
                                                                out, M, C, eps);
  return (int)cudaGetLastError();
}
