// K4 `biased_attention_bwd`: the VJP of the per-sample attention core
//   ctx = softmax(q k^T * scale + kbias) v     (per group g, head h)
// with respect to the fused QKV rows and the key bias, for sm_90a.
//
// Replaces `_seq_core_bwd_kernel` (mvlt_tpu/ops/pallas_attn.py:2413, entry
// `seq_attention_core_bwd` :2536), key-bias mode, as its interpret path
// (`fast=False`) computes it: for each (g, h), from the saved QKV rows
// (G*N, 3C) and dctx (G*N, C) in bf16, all in f32,
//   s  = (q * scale) k^T + kbias[g]             (recomputed)
//   p  = exp(s - max_j s) / sum_j exp(...)      (exact divide)
//   dv = p^T dctx,  dp = dctx v^T
//   ds = p * (dp - rowsum(p * dp))
//   dq = ds k * scale,  dk = ds^T (q * scale)
// dqkv is written in bf16 (the dtype of qkv, as the TPU kernel writes it);
// dkbias[g, j] = sum over heads and rows i of ds[i, j], in f32.
//
// Bound: about 5 N^2 Dh multiply-adds per (g, h) against one read of the
// block's q, k, v, dctx and one write of dq, dk, dv: at N = 74, Dh = 64 that
// is ~30 flop per byte, so on the tensor cores this would be memory-bound;
// with scalar FMA it is bound by the f32 pipe and shared-memory reads. One
// block per (group, head) keeps q, k, v, dctx and both N x N f32 tiles (p and
// ds) in shared memory (~121 KB at N = 74, Dh = 64, opted in above 48 KB), so
// no score-sized tensor touches device memory, as on the TPU. The per-head
// column sums of ds go to a (G, nH, N) f32 scratch that a second small kernel
// sums over heads in a fixed order (deterministic, no atomics). Tensor cores
// for the five products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_N = 128;
constexpr int MAX_DH = 64;

__global__ void __launch_bounds__(THREADS)
attention_bwd_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dctx,
                     const float* __restrict__ kbias, __nv_bfloat16* __restrict__ dqkv,
                     float* __restrict__ dkb_part, int N, int C, int Dh, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int ldk = Dh + 1;  // odd row stride: threads on consecutive keys hit distinct banks
  const int lds = N + 1;
  float* Q = sm;                 // N x Dh, pre-scaled
  float* Kt = Q + N * Dh;        // N x ldk
  float* V = Kt + N * ldk;       // N x ldk
  float* D = V + N * ldk;        // N x Dh   (dctx)
  float* P = D + N * Dh;         // N x lds
  float* S = P + N * lds;        // N x lds  (dp, then ds)

  const int h = blockIdx.x;
  const int g = blockIdx.y;
  const int nH = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t row0 = (size_t)g * N;
  const int ld = 3 * C;

  for (int e = tid; e < N * Dh; e += THREADS) {
    int n = e / Dh, d = e % Dh;
    const __nv_bfloat16* r = qkv + (row0 + n) * ld + h * Dh + d;
    Q[n * Dh + d] = __bfloat162float(r[0]) * scale;
    Kt[n * ldk + d] = __bfloat162float(r[C]);
    V[n * ldk + d] = __bfloat162float(r[2 * C]);
    D[n * Dh + d] = __bfloat162float(dctx[(row0 + n) * C + h * Dh + d]);
  }
  __syncthreads();

  // scores and dp = dctx v^T
  const float* kb = kbias ? kbias + (size_t)g * N : nullptr;
  for (int e = tid; e < N * N; e += THREADS) {
    int i = e / N, j = e % N;
    const float* q = Q + i * Dh;
    const float* k = Kt + j * ldk;
    const float* dc = D + i * Dh;
    const float* v = V + j * ldk;
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < Dh; ++d) {
      s = fmaf(q[d], k[d], s);
      dp = fmaf(dc[d], v[d], dp);
    }
    if (kb) s += kb[j];
    P[i * lds + j] = s;
    S[i * lds + j] = dp;
  }
  __syncthreads();

  // one warp per row: p by the max-subtracted softmax with an exact divide,
  // then ds = p * (dp - rowsum(p * dp))
  for (int i = tid >> 5; i < N; i += THREADS / 32) {
    float* prow = P + i * lds;
    float* srow = S + i * lds;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, prow[j]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    float rd = 0.f;
    for (int j = lane; j < N; j += 32) {
      float pv = prow[j] / sum;
      prow[j] = pv;
      rd = fmaf(pv, srow[j], rd);
    }
    for (int o = 16; o > 0; o >>= 1) rd += __shfl_xor_sync(0xffffffffu, rd, o);
    for (int j = lane; j < N; j += 32) srow[j] = prow[j] * srow[j] - prow[j] * rd;
  }
  __syncthreads();

  // dq_i = scale * sum_j ds_ij k_j;  dk_j = sum_i ds_ij q_i;  dv_j = sum_i p_ij dctx_i
  for (int e = tid; e < N * Dh; e += THREADS) {
    int r = e / Dh, d = e % Dh;
    float dq = 0.f, dk = 0.f, dv = 0.f;
    for (int t = 0; t < N; ++t) {
      dq = fmaf(S[r * lds + t], Kt[t * ldk + d], dq);
      dk = fmaf(S[t * lds + r], Q[t * Dh + d], dk);
      dv = fmaf(P[t * lds + r], D[t * Dh + d], dv);
    }
    __nv_bfloat16* out = dqkv + (row0 + r) * ld + h * Dh + d;
    out[0] = __float2bfloat16(dq * scale);
    out[C] = __float2bfloat16(dk);
    out[2 * C] = __float2bfloat16(dv);
  }

  // this head's column sums of ds
  float* part = dkb_part + ((size_t)g * nH + h) * N;
  for (int j = tid; j < N; j += THREADS) {
    float c = 0.f;
    for (int i = 0; i < N; ++i) c += S[i * lds + j];
    part[j] = c;
  }
}

__global__ void sum_heads_kernel(const float* __restrict__ part, float* __restrict__ dkb, int G, int nH,
                                 int N) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= G * N) return;
  int g = e / N, j = e % N;
  float c = 0.f;
  for (int h = 0; h < nH; ++h) c += part[((size_t)g * nH + h) * N + j];
  dkb[e] = c;
}

}  // namespace

// dkb_part: (G, nH, N) f32 scratch; dkbias: (G, N) f32; kbias may be null.
extern "C" int mvlt_attention_bwd(const void* qkv, const void* dctx, const void* kbias, void* dqkv,
                                  void* dkb_part, void* dkbias, int G, int N, int C, int nH, float scale,
                                  void* stream) {
  if (N < 1 || N > MAX_N || C % nH != 0 || C / nH > MAX_DH) return (int)cudaErrorInvalidValue;
  const int Dh = C / nH;
  const size_t smem =
      sizeof(float) * ((size_t)N * Dh * 2 + (size_t)N * (Dh + 1) * 2 + (size_t)N * (N + 1) * 2);
  static size_t attr_bytes = 0;  // above 48 KB needs the opt-in
  if (smem > attr_bytes) {
    cudaError_t e = cudaFuncSetAttribute(attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = smem;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  attention_bwd_kernel<<<dim3(nH, G), THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dctx),
      static_cast<const float*>(kbias), static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(dkb_part), N, C,
      Dh, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_heads_kernel<<<(G * N + 255) / 256, 256, 0, s>>>(static_cast<const float*>(dkb_part),
                                                        static_cast<float*>(dkbias), G, nH, N);
  return (int)cudaGetLastError();
}
