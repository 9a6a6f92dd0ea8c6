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
// Bound: memory (one read of x, one write of y: ~4 flop per byte). A row
// group of lanes sized to C (norm.cuh: 8 rows a warp at C = 96, 4 at 192, 2
// at 384, 1 at 768 and above; C <= 2048) reads its row once, in 16-byte
// words, into registers;
// both moments are taken there, and y leaves in 16-byte words. C % 8 != 0
// runs element by element. The plan (one row group per row, rows_per_block
// rows a block) is mirrored in mvlt_tpu_torch/ops/kernels.py (`layernorm_plan`).

#include "norm.cuh"

namespace {

using namespace mvlt;

constexpr int LN_MAX_C = 2048;  // the widest row: Swin-B's last patch merge

template <int G, int J>
__global__ void __launch_bounds__(NORM_WARPS * 32)
layernorm_kernel(const void* __restrict__ x, int x_f32, const int* __restrict__ gidx,
                 const float* __restrict__ gamma, const float* __restrict__ beta, __nv_bfloat16* __restrict__ y,
                 int M, int C, float eps, int vec) {
  constexpr int RPW = 32 / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int li = lane & (G - 1), rg = lane / G;
  const int m = blockIdx.x * (NORM_WARPS * RPW) + warp * RPW + rg;
  const bool live = m < M;
  const size_t src = (size_t)(live ? (gidx ? gidx[m] : m) : 0) * C;
  const float invC = 1.0f / (float)C;

  float v[J][8];
  int valid[J];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c0 = (j * G + li) * NORM_VEC;
    valid[j] = live ? C - c0 : 0;
    if (valid[j] > 0) {
      load8(x, src + c0, x_f32, vec, valid[j], v[j]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[j][e] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[j][e];
  const float mu = group_sum<G>(sum) * invC;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = e < valid[j] ? v[j][e] - mu : 0.f;
      sq += d * d;
    }
  const float rstd = rsqrtf(group_sum<G>(sq) * invC + eps);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (valid[j] <= 0) continue;
    const int c0 = (j * G + li) * NORM_VEC;
    float gam[8], bet[8];
    load8(gamma, c0, true, vec, valid[j], gam);
    load8(beta, c0, true, vec, valid[j], bet);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[j][e] = (v[j][e] - mu) * rstd * gam[e] + bet[e];
    store8(y, (size_t)m * C + c0, vec, valid[j], v[j]);
  }
}

struct Args {
  const void* x;
  int x_f32;
  const int* gidx;
  const float *gamma, *beta;
  __nv_bfloat16* y;
  int M, C;
  float eps;
};

template <int G, int J>
cudaError_t launch(const Args& a, const RowPlan& p, int blocks, cudaStream_t s) {
  layernorm_kernel<G, J><<<blocks, NORM_WARPS * 32, 0, s>>>(a.x, a.x_f32, a.gidx, a.gamma, a.beta, a.y, a.M, a.C,
                                                           a.eps, p.vec);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_chunks(const Args& a, const RowPlan& p, int blocks, cudaStream_t s) {
  switch (p.chunks) {
    case 1: return launch<G, 1>(a, p, blocks, s);
    case 2: return launch<G, 2>(a, p, blocks, s);
    case 3: return launch<G, 3>(a, p, blocks, s);
    case 4: return launch<G, 4>(a, p, blocks, s);
  }
  return cudaErrorInvalidValue;
}

// C above 1024: the warp takes the row, 5 .. 8 chunks a lane
cudaError_t launch_wide(const Args& a, const RowPlan& p, int blocks, cudaStream_t s) {
  switch (p.chunks) {
    case 5: return launch<32, 5>(a, p, blocks, s);
    case 6: return launch<32, 6>(a, p, blocks, s);
    case 7: return launch<32, 7>(a, p, blocks, s);
    case 8: return launch<32, 8>(a, p, blocks, s);
  }
  return launch_chunks<32>(a, p, blocks, s);
}

RowPlan plan(int M, int C) { return M < 1 ? RowPlan{0, 0, 0, 0} : row_plan(C, LN_MAX_C); }

}  // namespace

// The plan of mvlt_layernorm for M rows of C: out = [lanes, chunks,
// rows_per_block, vec, blocks]. Returns -1 (out all 0) for M < 1, C < 1 or
// C > 2048.
extern "C" int mvlt_layernorm_plan(int M, int C, int* out) {
  RowPlan p = plan(M, C);
  int blocks = p.lanes ? (M + p.rows_per_block - 1) / p.rows_per_block : 0;
  int v[5] = {p.lanes, p.chunks, p.rows_per_block, p.vec, blocks};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return p.lanes ? 0 : -1;
}

extern "C" int mvlt_layernorm(const void* x, const void* gidx, const void* gamma, const void* beta, void* y,
                              int M, int C, float eps, int x_f32, void* stream) {
  RowPlan p = plan(M, C);
  if (p.lanes == 0) return (int)cudaErrorInvalidValue;
  const int blocks = (M + p.rows_per_block - 1) / p.rows_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{x, x_f32, static_cast<const int*>(gidx), static_cast<const float*>(gamma), static_cast<const float*>(beta),
         static_cast<__nv_bfloat16*>(y), M, C, eps};
  switch (p.lanes) {
    case 1: return (int)launch_chunks<1>(a, p, blocks, s);
    case 2: return (int)launch_chunks<2>(a, p, blocks, s);
    case 4: return (int)launch_chunks<4>(a, p, blocks, s);
    case 8: return (int)launch_chunks<8>(a, p, blocks, s);
    case 16: return (int)launch_chunks<16>(a, p, blocks, s);
    case 32: return (int)launch_wide(a, p, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}
