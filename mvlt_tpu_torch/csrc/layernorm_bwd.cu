// K5 `layernorm_bwd` and `column_sum`: the LayerNorm VJP from the saved
// pre-LN sum, with the cross-row gradient sums, for sm_90a.
//
// Replaces the LN-backward and column-sum parts of `_mlp_ln_bwd_kernel`
// (mvlt_tpu/ops/pallas_attn.py:2931; lines 2970-2991 and 3003), the LN VJP
// of `_attn_ln_bwd_stored` (:2645-2649), and the pre-LN LN2 / LN1 VJPs of the
// Swin block's store-residual backward: `_swin_mlp_bwd_kernel` (:1698-1709,
// with `da = dres1 * dp1` and `dbproj` of `_stored_block_bwd` :1927-1973) and
// `_swin_qkv_tail_kernel` (:1823-1830). Per row m of the pre-LN sum res (M, C)
// (f32, or the bf16 window rows of LN1), with gamma (C,) f32 and the upstream
// gradient g (M, C) (bf16, or f32 for the pre-LN form's dh):
//   xhat = (res - mean) * r,  r = rsqrt(var + eps)   (two-pass moments, as K3)
//   dxhat = g * gamma
//   dres = r * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//          + gres                        (optional incoming residual gradient, bf16 or
//                                         f32: the pre-LN form's dres1 = g + LN2^T(dh2))
//   da   = dres * hmask * S[m / s_div]   (optional bf16 hidden-dropout mask and f32 row
//                                         scale, the DropPath multiplier dp1; da = dres
//                                         without them)
// with the f32 dres (for the residual path), an optional bf16 copy of da (the
// cotangent of the proj / fc2 output, or the block's dx), and the column sums
// over rows
//   dgamma = sum g * xhat,  dbeta = sum g,  db = sum da   (the fc2 / proj bias grad:
//   `da` / `dbproj` at pallas_attn.py:2651,2663,1973 and `dmlp` / `db2` at :2984,2989).
// `column_sum` is the plain column sum of a bf16 or f32 (M, N) matrix (db1 over
// the (M, 3072) fc1 cotangent, dbqkv over dQKV); with a row scale it sums
// x * S[m / s_div] and writes that product as a bf16 copy (dmlp = g * dp2 and
// db2 of `_swin_mlp_bwd_kernel` :1685-1690).
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

// flags of the pre-LN form
constexpr int RES_BF16 = 1, G_F32 = 2, GRES_F32 = 4;

__device__ __forceinline__ float load(const void* p, size_t i, bool f32) {
  return f32 ? static_cast<const float*>(p)[i] : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

template <int CPL>
__global__ void __launch_bounds__(WARPS * 32)
ln_bwd_kernel(const void* __restrict__ res, const float* __restrict__ gamma, const void* __restrict__ g,
              const __nv_bfloat16* __restrict__ hmask, const void* __restrict__ gres,
              const float* __restrict__ rscale, float* __restrict__ dres, __nv_bfloat16* __restrict__ dres_bf,
              float* __restrict__ part, int M, int C, float eps, int flags, int s_div) {
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

  // a grid-stride loop over groups of ROWS_PER_BLOCK rows: the grid is capped
  // (mvlt_layernorm_bwd_blocks), so the partial sums stay few at any M
  for (int m0 = blockIdx.x * ROWS_PER_BLOCK; m0 < M; m0 += gridDim.x * ROWS_PER_BLOCK)
  for (int k = 0; k < RPW; ++k) {
    const int m = m0 + k * WARPS + warp;
    if (m >= M) break;
    const size_t row = (size_t)m * C;
    float x[CPL], gv[CPL];
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      int c = t * 32 + lane;
      x[t] = c < C ? load(res, row + c, !(flags & RES_BF16)) : 0.f;
      gv[t] = c < C ? load(g, row + c, flags & G_F32) : 0.f;
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
    const float rs = rscale ? rscale[m / s_div] : 1.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      int c = t * 32 + lane;
      if (c >= C) continue;
      float d = r * (gv[t] * gam[t] - mdx - x[t] * mdxx);
      if (gres) d += load(gres, row + c, flags & GRES_F32);
      dres[row + c] = d;
      if (hmask) d *= __bfloat162float(hmask[row + c]);
      if (rscale) d *= rs;
      if (dres_bf) dres_bf[row + c] = __float2bfloat16(d);
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

// part[chunk, c] = sum of x[r, c] (times S[r / s_div], also written to xs) over the rows of the chunk
template <typename T>
__global__ void colsum_kernel(const T* __restrict__ x, const float* __restrict__ rscale,
                              __nv_bfloat16* __restrict__ xs, float* __restrict__ part, int M, int N, int rows,
                              int s_div) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  int r0 = blockIdx.y * rows, r1 = min(M, r0 + rows);
  float v = 0.f;
  for (int r = r0; r < r1; ++r) {
    float e = to_f(x[(size_t)r * N + c]);
    if (rscale) {
      e *= rscale[r / s_div];
      xs[(size_t)r * N + c] = __float2bfloat16(e);
    }
    v += e;
  }
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

struct LnBwd {
  const void* res;
  const float* gamma;
  const void* g;
  const __nv_bfloat16* hmask;
  const void* gres;
  const float* rscale;
  float* dres;
  __nv_bfloat16* dres_bf;
  float* part;
  int M, C;
  float eps;
  int flags, s_div;
};

// blocks of ln_bwd_kernel: one per ROWS_PER_BLOCK rows, at most 8 per SM of an H100
int ln_bwd_blocks(int M) {
  int blocks = (M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  return blocks < 8 * 132 ? blocks : 8 * 132;
}

template <int CPL>
cudaError_t ln_bwd_launch(const LnBwd& a, cudaStream_t s) {
  int blocks = ln_bwd_blocks(a.M);
  ln_bwd_kernel<CPL><<<blocks, WARPS * 32, 0, s>>>(a.res, a.gamma, a.g, a.hmask, a.gres, a.rscale, a.dres,
                                                   a.dres_bf, a.part, a.M, a.C, a.eps, a.flags, a.s_div);
  return cudaGetLastError();
}

}  // namespace

// Scratch rows the caller must provide to mvlt_layernorm_bwd (part: rows x 3C f32).
extern "C" int mvlt_layernorm_bwd_blocks(int M) { return ln_bwd_blocks(M); }

// sums: (3, C) f32 out = [dgamma; dbeta; db]; hmask, gres, rscale and dres_bf may be null.
// flags: 1 res is bf16 (else f32), 2 g is f32 (else bf16), 4 gres is f32 (else bf16).
// rscale: f32 row scale of da, row m reads rscale[m / s_div].
extern "C" int mvlt_layernorm_bwd(const void* res, const void* gamma, const void* g, const void* hmask,
                                  const void* gres, const void* rscale, void* dres, void* dres_bf, void* part,
                                  void* sums, int M, int C, float eps, int flags, int s_div, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rscale != nullptr && s_div < 1) return (int)cudaErrorInvalidValue;
  LnBwd a{res, static_cast<const float*>(gamma), g, static_cast<const __nv_bfloat16*>(hmask), gres,
          static_cast<const float*>(rscale), static_cast<float*>(dres), static_cast<__nv_bfloat16*>(dres_bf),
          static_cast<float*>(part), M, C, eps, flags, s_div};
  cudaError_t e;
  if (C <= 128) e = ln_bwd_launch<4>(a, s);
  else if (C <= 256) e = ln_bwd_launch<8>(a, s);
  else if (C <= 512) e = ln_bwd_launch<16>(a, s);
  else if (C <= 768) e = ln_bwd_launch<24>(a, s);
  else if (C <= 1024) e = ln_bwd_launch<32>(a, s);
  else return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  int W = 3 * C;
  reduce_kernel<<<(W + 255) / 256, 256, 0, s>>>(a.part, static_cast<float*>(sums),
                                                mvlt_layernorm_bwd_blocks(M), W);
  return (int)cudaGetLastError();
}

// Row chunks of `column_sum` for an (M, N) input; part is chunks x N f32.
extern "C" int mvlt_column_sum_chunks(int M, int N) {
  int col_blocks = (N + 255) / 256;
  int chunks = (2 * 132 + col_blocks - 1) / col_blocks;
  return chunks < M ? (chunks > 0 ? chunks : 1) : (M > 0 ? M : 1);
}

// rscale (f32, row m reads rscale[m / s_div]) and xs (bf16 (M, N), the scaled copy) are both null or both given.
extern "C" int mvlt_column_sum(const void* x, int x_f32, const void* rscale, void* xs, void* part, void* out,
                               int M, int N, int s_div, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((rscale == nullptr) != (xs == nullptr) || (rscale != nullptr && s_div < 1)) return (int)cudaErrorInvalidValue;
  int chunks = mvlt_column_sum_chunks(M, N);
  int rows = (M + chunks - 1) / chunks;
  dim3 grid((N + 255) / 256, chunks);
  auto rs = static_cast<const float*>(rscale);
  auto xo = static_cast<__nv_bfloat16*>(xs);
  auto pt = static_cast<float*>(part);
  if (x_f32)
    colsum_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x), rs, xo, pt, M, N, rows, s_div);
  else
    colsum_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x), rs, xo, pt, M, N,
                                                      rows, s_div);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<(N + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part), static_cast<float*>(out),
                                                chunks, N);
  return (int)cudaGetLastError();
}
