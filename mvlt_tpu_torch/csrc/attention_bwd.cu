// K4 `biased_attention_bwd`: the VJP of the per-sample attention core
//   ctx = (softmax(q k^T * scale + kbias + qbias) * amask) v     (per group g, head h)
// with respect to the fused QKV rows and the key bias, for sm_90a.
//
// Replaces `_seq_core_bwd_kernel` (mvlt_tpu/ops/pallas_attn.py:2413, entry
// `seq_attention_core_bwd` :2536) as its interpret path (`fast=False`)
// computes it: for each (g, h), from the saved QKV rows (G*N, 3C) and dctx
// (G*N, C) in bf16, all in f32,
//   s  = (q * scale) k^T + kbias[g] + qbias[g]  (recomputed; both biases optional)
//   p  = exp(s - max_j s) / sum_j exp(...)      (exact divide)
//   pa = p * amask[g, h]                        (optional dropout mask, 0 or 1/keep)
//   dv = pa^T dctx,  dp = (dctx v^T) * amask[g, h]
//   ds = p * (dp - rowsum(p * dp))
//   dq = ds k * scale,  dk = ds^T (q * scale)
// dqkv is written in bf16 (the dtype of qkv, as the TPU kernel writes it);
// dkbias[g, j] = sum over heads and rows i of ds[i, j], in f32. p (unmasked)
// enters ds and pa enters dv, as at pallas_attn.py:2482-2501.
//
// Bound: about 5 N^2 Dh multiply-adds per (g, h) against one read of the
// block's q, k, v, dctx (and the masks) and one write of dq, dk, dv: at
// N = 131, Dh = 64 that is ~50 flop per byte, so on the tensor cores this
// would be memory-bound; with scalar FMA it is bound by the f32 pipe and
// shared-memory reads. One block per (group, head) keeps q, k, v and dctx as
// bf16 (exact: they are bf16 in device memory) and the p and ds N x N tiles
// as f32 in shared memory, so no score-sized tensor touches device memory,
// as on the TPU; qbias and amask are read from device memory where used. At
// Dh = 64 that is 207,504 bytes at N = 131 and admits N <= 140 within the
// 232,448 bytes a block may opt in to (`smem_bytes` below; the wrapper in
// ops/kernels.py mirrors it). The per-head column sums of ds go to a
// (G, nH, N) f32 scratch that a second small kernel sums over heads in a
// fixed order (deterministic, no atomics). Tensor cores for the five
// products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DH = 64;
constexpr size_t H100_SMEM_OPTIN = 232448;

// q, k, v, dctx: bf16 rows of Dh + 2 (an odd count of 4-byte words, so
// threads on consecutive rows hit distinct banks); p, ds: f32 rows of N + 1
__host__ __device__ constexpr size_t smem_bytes(int N, int Dh) {
  return 2 * 4 * (size_t)N * (Dh + 2) + 4 * 2 * (size_t)N * (N + 1);
}
// the largest N at MAX_DH on an H100
constexpr int MAX_N = 140;
static_assert(smem_bytes(MAX_N, MAX_DH) <= H100_SMEM_OPTIN && smem_bytes(MAX_N + 1, MAX_DH) > H100_SMEM_OPTIN,
              "MAX_N follows smem_bytes");

__global__ void __launch_bounds__(THREADS)
attention_bwd_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dctx,
                     const float* __restrict__ kbias, const float* __restrict__ qbias,
                     const __nv_bfloat16* __restrict__ amask, __nv_bfloat16* __restrict__ dqkv,
                     float* __restrict__ dkb_part, int N, int C, int Dh, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldb = Dh + 2;  // bf16 row
  const int lds = N + 1;   // f32 row
  __nv_bfloat16* Q = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // N x ldb, unscaled
  __nv_bfloat16* K = Q + N * ldb;
  __nv_bfloat16* V = K + N * ldb;
  __nv_bfloat16* D = V + N * ldb;                                   // dctx
  float* P = reinterpret_cast<float*>(D + N * ldb);                 // N x lds: p, then pa
  float* S = P + N * lds;                                           // N x lds: dp, then ds

  const int h = blockIdx.x;
  const int g = blockIdx.y;
  const int nH = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t row0 = (size_t)g * N;
  const int ld = 3 * C;
  const int hd = Dh / 2;  // bf16 pairs in a head row

  for (int e = tid; e < N * hd; e += THREADS) {
    int n = e / hd, d = 2 * (e % hd);
    const __nv_bfloat16* r = qkv + (row0 + n) * ld + h * Dh + d;
    *reinterpret_cast<__nv_bfloat162*>(Q + n * ldb + d) = *reinterpret_cast<const __nv_bfloat162*>(r);
    *reinterpret_cast<__nv_bfloat162*>(K + n * ldb + d) = *reinterpret_cast<const __nv_bfloat162*>(r + C);
    *reinterpret_cast<__nv_bfloat162*>(V + n * ldb + d) = *reinterpret_cast<const __nv_bfloat162*>(r + 2 * C);
    *reinterpret_cast<__nv_bfloat162*>(D + n * ldb + d) =
        *reinterpret_cast<const __nv_bfloat162*>(dctx + (row0 + n) * C + h * Dh + d);
  }
  __syncthreads();

  // scores and dp = (dctx v^T) * amask
  const float* kb = kbias ? kbias + (size_t)g * N : nullptr;
  const float* qb = qbias ? qbias + (size_t)g * N * N : nullptr;
  const __nv_bfloat16* am = amask ? amask + ((size_t)g * nH + h) * N * N : nullptr;
  for (int e = tid; e < N * N; e += THREADS) {
    int i = e / N, j = e % N;
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(Q + i * ldb);
    const __nv_bfloat162* k = reinterpret_cast<const __nv_bfloat162*>(K + j * ldb);
    const __nv_bfloat162* dc = reinterpret_cast<const __nv_bfloat162*>(D + i * ldb);
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(V + j * ldb);
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < hd; ++d) {
      float2 qf = __bfloat1622float2(q[d]), kf = __bfloat1622float2(k[d]);
      float2 cf = __bfloat1622float2(dc[d]), vf = __bfloat1622float2(v[d]);
      s = fmaf(qf.x * scale, kf.x, s);
      s = fmaf(qf.y * scale, kf.y, s);
      dp = fmaf(cf.x, vf.x, dp);
      dp = fmaf(cf.y, vf.y, dp);
    }
    if (kb) s += kb[j];
    if (qb) s += qb[i * N + j];
    if (am) dp *= __bfloat162float(am[i * N + j]);
    P[i * lds + j] = s;
    S[i * lds + j] = dp;
  }
  __syncthreads();

  // one warp per row: p by the max-subtracted softmax with an exact divide,
  // ds = p * dp - p * rowsum(p * dp), then P holds pa = p * amask
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
    for (int j = lane; j < N; j += 32) {
      float pv = prow[j];
      srow[j] = pv * srow[j] - pv * rd;
      if (am) prow[j] = pv * __bfloat162float(am[i * N + j]);
    }
  }
  __syncthreads();

  // two head columns d, d + 1 a thread:
  // dq_i = scale * sum_j ds_ij k_j;  dk_j = sum_i ds_ij (q_i * scale);  dv_j = sum_i pa_ij dctx_i
  for (int e = tid; e < N * hd; e += THREADS) {
    int r = e / hd, d = 2 * (e % hd);
    float2 dq = make_float2(0.f, 0.f), dk = dq, dv = dq;
    for (int t = 0; t < N; ++t) {
      float sr = S[r * lds + t], sc = S[t * lds + r], pc = P[t * lds + r];
      float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(K + t * ldb + d));
      float2 qf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Q + t * ldb + d));
      float2 cf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(D + t * ldb + d));
      dq.x = fmaf(sr, kf.x, dq.x);
      dq.y = fmaf(sr, kf.y, dq.y);
      dk.x = fmaf(sc, qf.x * scale, dk.x);
      dk.y = fmaf(sc, qf.y * scale, dk.y);
      dv.x = fmaf(pc, cf.x, dv.x);
      dv.y = fmaf(pc, cf.y, dv.y);
    }
    __nv_bfloat16* out = dqkv + (row0 + r) * ld + h * Dh + d;
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(dq.x * scale, dq.y * scale);
    *reinterpret_cast<__nv_bfloat162*>(out + C) = __floats2bfloat162_rn(dk.x, dk.y);
    *reinterpret_cast<__nv_bfloat162*>(out + 2 * C) = __floats2bfloat162_rn(dv.x, dv.y);
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

int smem_optin() {
  static int bytes = -1;  // queried once
  if (bytes < 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
      bytes = -1;
  }
  return bytes;
}

}  // namespace

// Shared memory one block needs for (N, Dh); the wrapper checks it against the card's opt-in limit.
extern "C" long long mvlt_attention_bwd_smem(int N, int Dh) { return (long long)smem_bytes(N, Dh); }

// dkb_part: (G, nH, N) f32 scratch; dkbias: (G, N) f32; kbias (G, N) f32, qbias (G, N, N) f32 and
// amask (G, nH, N, N) bf16 may each be null.
extern "C" int mvlt_attention_bwd(const void* qkv, const void* dctx, const void* kbias, const void* qbias,
                                  const void* amask, void* dqkv, void* dkb_part, void* dkbias, int G, int N,
                                  int C, int nH, float scale, void* stream) {
  if (N < 1 || nH < 1 || C % nH != 0 || C / nH > MAX_DH || (C / nH) % 2 != 0) return (int)cudaErrorInvalidValue;
  const int Dh = C / nH;
  const size_t smem = smem_bytes(N, Dh);
  const int optin = smem_optin();
  if (optin < 0 || smem > (size_t)optin) return (int)cudaErrorInvalidValue;
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
      static_cast<const float*>(kbias), static_cast<const float*>(qbias),
      static_cast<const __nv_bfloat16*>(amask), static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(dkb_part),
      N, C, Dh, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_heads_kernel<<<(G * N + 255) / 256, 256, 0, s>>>(static_cast<const float*>(dkb_part),
                                                        static_cast<float*>(dkbias), G, nH, N);
  return (int)cudaGetLastError();
}
