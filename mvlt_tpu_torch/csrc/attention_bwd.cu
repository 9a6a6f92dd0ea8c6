// K4 `biased_attention_bwd`: the VJP of the per-group attention core
//   ctx = (softmax(q k^T * scale + pattern[g % P] + kbias + qbias) * amask) v   (per group g, head h)
// with respect to the fused QKV rows, the key bias and the bias patterns, for sm_90a.
//
// Replaces `_seq_core_bwd_kernel` (mvlt_tpu/ops/pallas_attn.py:2413, entry
// `seq_attention_core_bwd` :2536) and the windowed cores `_core_bwd_kernel2d`
// (:3782, entry `attention_core_bwd_flat` :3898) and `_core_bwd_kernel` (:3637,
// entry `attention_core_bwd` :4067) as their interpret path (`fast=False`)
// computes them: for each (g, h), from the saved QKV rows (G*N, 3C) and dctx
// (G*N, C) in bf16, all in f32,
//   s  = (q * scale) k^T + pattern[g % P, h] + kbias[g] + qbias[g]  (recomputed; each optional)
//   p  = exp(s - max_j s) / sum_j exp(...)      (exact divide)
//   pa = p * amask[g, h]                        (optional dropout mask, 0 or 1/keep)
//   dv = pa^T dctx,  dp = (dctx v^T) * amask[g, h]
//   ds = p * (dp - rowsum(p * dp))
//   dq = ds k * scale,  dk = ds^T (q * scale)
// dqkv is written in bf16 (the dtype of qkv, as the TPU kernel writes it);
// dkbias[g, j] = sum over heads and rows i of ds[i, j], in f32; dpattern[p, h]
// = sum of ds over the G / P groups g with g % P == p (the Swin windows that
// share a relative-position / shift-mask pattern), in f32. p (unmasked)
// enters ds and pa enters dv, as at pallas_attn.py:2482-2501.
//
// Two opt-in modes, neither with shared memory of its own (K4 uses 207,504
// of the 232,448 bytes at N = 131, head dim 64; N = 141 stays refused):
// (a) regenerated dropout (`_seq_core_bwd_kernel` with `adrop_rate`, :2485):
//     the mask is redrawn from the (2,) int32 device seed with K2's Philox
//     stream (philox.cuh), bit for bit, where amask enters: in dp and in pa;
// (b) stored p (`_core_bwd_storep_kernel` :3859 and `_core_bwd_from_p`
//     :3747-3770): p (G, nH, N, N) bf16, saved by K2's mode (b), is read
//     into the p tile in place of the QK^T recompute and the exp; dv takes
//     the bf16 p and ds = p * dp - p * rowsum(p * dp) runs in f32 from it.
//     The key bias and the patterns no longer enter p; dkbias and the
//     fixed-order pattern sums are written as before.
//
// Bound: about 5 N^2 Dh multiply-adds per (g, h) against one read of the
// block's q, k, v, dctx (and the masks) and one write of dq, dk, dv: at
// N = 131, Dh = 64 that is ~50 flop per byte, so on the tensor cores this
// would be memory-bound; with scalar FMA it is bound by the f32 pipe and
// shared-memory reads. A block serves one head and a run of groups: with no
// pattern one group (grid (nH, G)); in pattern mode the groups p, p + P,
// p + 2P, ... of one pattern p, `wpb` of them (grid (nH, P, chunks)). For each
// group it keeps q, k, v and dctx as bf16 (exact: they are bf16 in device
// memory) and the p and ds N x N tiles as f32 in shared memory, so no
// score-sized tensor touches device memory, as on the TPU; qbias and amask
// are read from device memory where used. At Dh = 64 that is 207,504 bytes
// at N = 131 and admits N <= 140 within the 232,448 bytes a block may opt in
// to (`smem_bytes` below; the wrapper in ops/kernels.py mirrors it); pattern
// mode adds an N x N f32 tile that sums ds over the block's groups (at the
// Swin windows, N = 49 and Dh = 32: 43,512 bytes). The cross-block sums are
// deterministic, with no atomics: the per-head column sums of ds go to a
// (G, nH, N) f32 scratch that a second small kernel sums over heads in a
// fixed order, and each block's pattern sum to a (chunks, P, nH, N, N) f32
// scratch that a third sums over chunks in order. Blocks per pattern are
// chosen to put about 1024 blocks on the card, so the scratch stays near
// 1024 * N^2 floats (10 MB at N = 49) where per-window partials would take
// 59 MB at Swin-S stage 1 (b32). Tensor cores for the five products are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DH = 64;
constexpr size_t H100_SMEM_OPTIN = 232448;

// q, k, v, dctx: bf16 rows of Dh + 2 (an odd count of 4-byte words, so
// threads on consecutive rows hit distinct banks); p, ds: f32 rows of N + 1;
// in pattern mode the N x N f32 sum of ds
__host__ __device__ constexpr size_t smem_bytes(int N, int Dh, bool pattern = false) {
  return 2 * 4 * (size_t)N * (Dh + 2) + 4 * 2 * (size_t)N * (N + 1) + (pattern ? 4 * (size_t)N * N : 0);
}
// blocks the pattern mode aims to put on the card
constexpr int TARGET_BLOCKS = 1024;
// the largest N at MAX_DH on an H100
constexpr int MAX_N = 140;
static_assert(smem_bytes(MAX_N, MAX_DH) <= H100_SMEM_OPTIN && smem_bytes(MAX_N + 1, MAX_DH) > H100_SMEM_OPTIN,
              "MAX_N follows smem_bytes");

__global__ void __launch_bounds__(THREADS)
attention_bwd_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dctx,
                     const float* __restrict__ pattern, const float* __restrict__ kbias,
                     const float* __restrict__ qbias, const __nv_bfloat16* __restrict__ amask,
                     const int* __restrict__ seed, uint32_t thresh, float kept,
                     const __nv_bfloat16* __restrict__ pstore, __nv_bfloat16* __restrict__ dqkv,
                     float* __restrict__ dkb_part,
                     float* __restrict__ dpat_part, int N, int C, int Dh, int P, int per, int wpb, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldb = Dh + 2;  // bf16 row
  const int lds = N + 1;   // f32 row
  __nv_bfloat16* Q = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // N x ldb, unscaled
  __nv_bfloat16* K = Q + N * ldb;
  __nv_bfloat16* V = K + N * ldb;
  __nv_bfloat16* D = V + N * ldb;                                   // dctx
  float* Pm = reinterpret_cast<float*>(D + N * ldb);                // N x lds: p, then pa
  float* S = Pm + N * lds;                                          // N x lds: dp, then ds
  float* A = S + N * lds;                                           // N x N: sum of ds (pattern mode)

  const int h = blockIdx.x;
  const int pat = blockIdx.y;  // the pattern (pattern mode), else the group
  const int nH = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ld = 3 * C;
  const int hd = Dh / 2;  // bf16 pairs in a head row
  const float* pb = pattern ? pattern + ((size_t)pat * nH + h) * N * N : nullptr;
  const uint32_t key = seed ? mvlt::adrop_key(seed) : 0u;
  if (pattern)
    for (int e = tid; e < N * N; e += THREADS) A[e] = 0.f;

  const int j0 = blockIdx.z * wpb;
  const int j1 = min(per, j0 + wpb);
  for (int jw = j0; jw < j1; ++jw) {
    const int g = pat + jw * P;  // groups of one pattern, in order
    const size_t row0 = (size_t)g * N;
    __syncthreads();  // the previous group's tiles are no longer read
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

    // scores (or (b) the stored p) and dp = (dctx v^T) * mask
    const float* kb = kbias ? kbias + (size_t)g * N : nullptr;
    const float* qb = qbias ? qbias + (size_t)g * N * N : nullptr;
    const size_t tile = ((size_t)g * nH + h) * N * N;
    const __nv_bfloat16* am = amask ? amask + tile : nullptr;
    const __nv_bfloat16* ps = pstore ? pstore + tile : nullptr;
    const bool masked = am != nullptr || seed != nullptr;
    for (int e = tid; e < N * N; e += THREADS) {
      int i = e / N, j = e % N;
      const __nv_bfloat162* dc = reinterpret_cast<const __nv_bfloat162*>(D + i * ldb);
      const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(V + j * ldb);
      float dp = 0.f;
      if (ps) {
        for (int d = 0; d < hd; ++d) {
          float2 cf = __bfloat1622float2(dc[d]), vf = __bfloat1622float2(v[d]);
          dp = fmaf(cf.x, vf.x, dp);
          dp = fmaf(cf.y, vf.y, dp);
        }
        Pm[i * lds + j] = __bfloat162float(ps[e]);
      } else {
        const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(Q + i * ldb);
        const __nv_bfloat162* k = reinterpret_cast<const __nv_bfloat162*>(K + j * ldb);
        float sc = 0.f;
        for (int d = 0; d < hd; ++d) {
          float2 qf = __bfloat1622float2(q[d]), kf = __bfloat1622float2(k[d]);
          float2 cf = __bfloat1622float2(dc[d]), vf = __bfloat1622float2(v[d]);
          sc = fmaf(qf.x * scale, kf.x, sc);
          sc = fmaf(qf.y * scale, kf.y, sc);
          dp = fmaf(cf.x, vf.x, dp);
          dp = fmaf(cf.y, vf.y, dp);
        }
        if (pb) sc += pb[e];
        if (kb) sc += kb[j];
        if (qb) sc += qb[e];
        Pm[i * lds + j] = sc;
      }
      if (am) dp *= __bfloat162float(am[e]);
      if (seed) dp *= mvlt::adrop_keep(key, g, h, (uint32_t)e, thresh) ? kept : 0.f;
      S[i * lds + j] = dp;
    }
    __syncthreads();

    // one warp per row: p by the max-subtracted softmax with an exact divide
    // (or (b) as stored), ds = p * dp - p * rowsum(p * dp), then Pm holds
    // pa = p * mask
    for (int i = tid >> 5; i < N; i += THREADS / 32) {
      float* prow = Pm + i * lds;
      float* srow = S + i * lds;
      float rd = 0.f;
      if (ps) {
        for (int j = lane; j < N; j += 32) rd = fmaf(prow[j], srow[j], rd);
      } else {
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
        for (int j = lane; j < N; j += 32) {
          float pv = prow[j] / sum;
          prow[j] = pv;
          rd = fmaf(pv, srow[j], rd);
        }
      }
      for (int o = 16; o > 0; o >>= 1) rd += __shfl_xor_sync(0xffffffffu, rd, o);
      for (int j = lane; j < N; j += 32) {
        float pv = prow[j];
        srow[j] = pv * srow[j] - pv * rd;
        if (!masked) continue;
        const uint32_t e = (uint32_t)(i * N + j);
        if (am) prow[j] = pv * __bfloat162float(am[e]);
        else prow[j] = pv * (mvlt::adrop_keep(key, g, h, e, thresh) ? kept : 0.f);
      }
    }
    __syncthreads();

    // two head columns d, d + 1 a thread:
    // dq_i = scale * sum_j ds_ij k_j;  dk_j = sum_i ds_ij (q_i * scale);  dv_j = sum_i pa_ij dctx_i
    for (int e = tid; e < N * hd; e += THREADS) {
      int r = e / hd, d = 2 * (e % hd);
      float2 dq = make_float2(0.f, 0.f), dk = dq, dv = dq;
      for (int t = 0; t < N; ++t) {
        float sr = S[r * lds + t], sc = S[t * lds + r], pc = Pm[t * lds + r];
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
    if (dkb_part) {
      float* part = dkb_part + ((size_t)g * nH + h) * N;
      for (int j = tid; j < N; j += THREADS) {
        float c = 0.f;
        for (int i = 0; i < N; ++i) c += S[i * lds + j];
        part[j] = c;
      }
    }
    // ds summed over the block's groups, each element by one thread, in group order
    if (pattern)
      for (int e = tid; e < N * N; e += THREADS) A[e] += S[(e / N) * lds + e % N];
  }

  if (pattern) {
    float* out = dpat_part + (((size_t)blockIdx.z * P + pat) * nH + h) * N * N;
    for (int e = tid; e < N * N; e += THREADS) out[e] = A[e];
  }
}

// dpattern[i] = sum over chunks c, in order, of part[c, i]
__global__ void sum_chunks_kernel(const float* __restrict__ part, float* __restrict__ dpattern, int chunks,
                                  size_t W) {
  size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= W) return;
  float c = 0.f;
  for (int k = 0; k < chunks; ++k) c += part[(size_t)k * W + e];
  dpattern[e] = c;
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

// (chunks, groups per block) of the pattern mode: about TARGET_BLOCKS blocks over nH * P patterns
void pattern_split(int G, int P, int nH, int* chunks, int* wpb) {
  const int per = G / P;
  int c = (TARGET_BLOCKS + nH * P - 1) / (nH * P);
  c = c < 1 ? 1 : (c > per ? per : c);
  *wpb = (per + c - 1) / c;
  *chunks = (per + *wpb - 1) / *wpb;
}

}  // namespace

// Shared memory one block needs for (N, Dh); the wrapper checks it against the card's opt-in limit.
extern "C" long long mvlt_attention_bwd_smem(int N, int Dh, int pattern) {
  return (long long)smem_bytes(N, Dh, pattern != 0);
}

// Chunks of the pattern mode for G groups and P patterns (the wrapper sizes dpat_part with it).
extern "C" int mvlt_attention_bwd_chunks(int G, int P, int nH) {
  if (P < 1 || G % P != 0 || nH < 1) return -1;
  int chunks, wpb;
  pattern_split(G, P, nH, &chunks, &wpb);
  return chunks;
}

// pattern (P, nH, N, N) f32 with G % P == 0, kbias (G, N) f32, qbias (G, N, N) f32 and amask
// (G, nH, N, N) bf16 may each be null. seed: null, or (2,) int32 16-bit halves for mode (a), with K2's
// thresh and kept; amask must be null with it, and nH <= 256. pstore: null, or (G, nH, N, N) bf16 p for
// mode (b). dkb_part: (G, nH, N) f32 scratch and dkbias (G, N) f32, both null to skip the key-bias
// gradient. With a pattern, dpat_part: (chunks, P, nH, N, N) f32 scratch (`mvlt_attention_bwd_chunks`)
// and dpattern (P, nH, N, N) f32.
extern "C" int mvlt_attention_bwd(const void* qkv, const void* dctx, const void* pattern, const void* kbias,
                                  const void* qbias, const void* amask, const void* seed, const void* pstore,
                                  void* dqkv, void* dkb_part, void* dkbias, void* dpat_part, void* dpattern,
                                  int G, int N, int C, int nH, int P, float scale, unsigned int thresh,
                                  float kept, void* stream) {
  if (N < 1 || nH < 1 || C % nH != 0 || C / nH > MAX_DH || (C / nH) % 2 != 0) return (int)cudaErrorInvalidValue;
  if (seed != nullptr && (amask != nullptr || nH > 256)) return (int)cudaErrorInvalidValue;
  if ((dkb_part == nullptr) != (dkbias == nullptr)) return (int)cudaErrorInvalidValue;
  if (pattern != nullptr && (P < 1 || G % P != 0 || dpat_part == nullptr || dpattern == nullptr))
    return (int)cudaErrorInvalidValue;
  const int Dh = C / nH;
  const size_t smem = smem_bytes(N, Dh, pattern != nullptr);
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
  int chunks = 1, wpb = 1, stride = G, per = 1;  // without a pattern: one group a block
  if (pattern != nullptr) {
    pattern_split(G, P, nH, &chunks, &wpb);
    stride = P;
    per = G / P;
  }
  attention_bwd_kernel<<<dim3(nH, stride, chunks), THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dctx),
      static_cast<const float*>(pattern), static_cast<const float*>(kbias), static_cast<const float*>(qbias),
      static_cast<const __nv_bfloat16*>(amask), static_cast<const int*>(seed), thresh, kept,
      static_cast<const __nv_bfloat16*>(pstore), static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(dkb_part),
      static_cast<float*>(dpat_part), N, C, Dh, stride, per, wpb, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (dkbias != nullptr) {
    sum_heads_kernel<<<(G * N + 255) / 256, 256, 0, s>>>(static_cast<const float*>(dkb_part),
                                                          static_cast<float*>(dkbias), G, nH, N);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (pattern != nullptr) {
    const size_t W = (size_t)P * nH * N * N;
    sum_chunks_kernel<<<(unsigned)((W + 255) / 256), 256, 0, s>>>(static_cast<const float*>(dpat_part),
                                                                  static_cast<float*>(dpattern), chunks, W);
    e = cudaGetLastError();
  }
  return (int)e;
}
