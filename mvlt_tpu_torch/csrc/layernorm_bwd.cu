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
// with the f32 dres (for the residual path; optional: LN1's VJP has no use
// for it), a bf16 copy of da (the cotangent of the proj / fc2 output, or the
// block's dx), and the column sums over rows
//   dgamma = sum g * xhat,  dbeta = sum g,  db = sum da   (the fc2 / proj bias grad:
//   `da` / `dbproj` at pallas_attn.py:2651,2663,1973 and `dmlp` / `db2` at :2984,2989).
// `column_sum` is the plain column sum of a bf16 or f32 (M, N) matrix (db1 over
// the (M, 3072) fc1 cotangent, dbqkv over dQKV); with a row scale it sums
// x * S[m / s_div] and writes that product as a bf16 copy (dmlp = g * dp2 and
// db2 of `_swin_mlp_bwd_kernel` :1685-1690).
//
// Bound: memory, a few flops a byte (12-16 bytes an element for the VJP, 2-4
// for the column sum). What the design does about it:
// - 16-byte accesses (norm.cuh): a row group of lanes sized to C reads each
//   row once into registers, every load of a row issued before the first is
//   used, and writes dres / da in 16-byte words; C = 96 / 192 / 384 take 8 /
//   4 / 2 rows a warp with no idle slot. C % 8 != 0 runs element by element.
// - Few partial rows: ln_bwd_kernel is persistent (one wave of blocks, as
//   many as the register cap lets sit on the card), each block keeps its
//   column sums in registers over all its rows and folds them once at the
//   end (the row groups by shuffles, the warps through shared memory), into
//   one partial row of the scratch.
// - column_sum as 2-D tiles: a block owns a strip of 8-column chunks and a
//   run of rows, 256 threads reading 16 bytes each, four rows' loads in
//   flight a thread; the grid is sized from the SM count so that four
//   blocks sit on each SM, in one wave; the row lanes fold in shared memory in a fixed
//   tree into one partial row per run.
// - fold_kernel sums the partial rows, each column spread over 32 warps.
// Every sum runs in an order that the plan alone fixes (no atomics), so two
// calls on the same inputs are bitwise equal. The plans are mirrored in
// mvlt_tpu_torch/ops/kernels.py (`layernorm_bwd_plan`, `column_sum_plan`);
// the launches refuse a scratch sized for another plan.

#include "norm.cuh"

namespace {

using namespace mvlt;

// flags of the pre-LN form
constexpr int RES_BF16 = 1, G_F32 = 2, GRES_F32 = 4;

constexpr int LN_BWD_MAX_C = 1024;  // four chunks a lane: the register cap
constexpr int COLSUM_THREADS = 256;
constexpr int COLSUM_BLOCKS_PER_SM = 4;
constexpr int COLSUM_UNROLL = 4;  // rows' loads in flight a thread
constexpr int FOLD_WARPS = 32;  // warps a column strip of the fold: rows in flight

// blocks of ln_bwd_kernel<lanes, chunks> that sit on one SM: the register cap
// of its launch bounds (170 registers a thread at 3, 255 at 2)
constexpr int ln_bwd_blocks_per_sm(int chunks) { return chunks <= 3 ? 3 : 2; }

struct LnBwdPlan {
  RowPlan rows;
  int passes, blocks;  // passes of rows_per_block rows; blocks = partial rows
};

LnBwdPlan ln_bwd_plan(int M, int C, int sms) {
  LnBwdPlan p{row_plan(C, LN_BWD_MAX_C), 0, 0};
  if (p.rows.lanes == 0 || M < 1 || sms < 1) return LnBwdPlan{RowPlan{0, 0, 0, 0}, 0, 0};
  p.passes = (M + p.rows.rows_per_block - 1) / p.rows.rows_per_block;
  int cap = ln_bwd_blocks_per_sm(p.rows.chunks) * sms;
  p.blocks = p.passes < cap ? p.passes : cap;
  return p;
}

struct ColsumPlan {
  int strip_chunks, strips, row_chunks, rows, vec;  // strip_chunks == 0: refused
};

// strip_chunks: the largest power of two that divides the 8-column chunk
// count, at most 32 (a strip of 256 columns); row chunks: as many runs of
// rows as keep the grid within COLSUM_BLOCKS_PER_SM blocks an SM (one wave:
// a block past it would run alone after the rest), each run at least one
// pass of the block's row lanes with all its loads in flight, none empty
ColsumPlan colsum_plan(int M, int N, int sms) {
  if (M < 1 || N < 1 || sms < 1) return ColsumPlan{0, 0, 0, 0, 0};
  const int n = (N + NORM_VEC - 1) / NORM_VEC;
  int sc = n & -n;
  if (sc > 32) sc = 32;
  const int strips = n / sc;
  const int per_pass = COLSUM_THREADS / sc * COLSUM_UNROLL;
  int chunks = COLSUM_BLOCKS_PER_SM * sms / strips;
  if (chunks < 1) chunks = 1;
  const int most = (M + per_pass - 1) / per_pass;
  if (chunks > most) chunks = most;
  const int rows = (M + chunks - 1) / chunks;
  return ColsumPlan{sc, strips, (M + rows - 1) / rows, rows, N % NORM_VEC == 0};
}

struct LnBwd {
  const void* res;
  const float* gamma;
  const void* g;
  const __nv_bfloat16* hmask;
  const void* gres;
  const float* rscale;
  float* dres;
  __nv_bfloat16* da;
  float* part;
  int M, C;
  float eps;
  int flags, s_div, vec, passes;
};

template <int G, int J>
__global__ void __launch_bounds__(NORM_WARPS * 32, ln_bwd_blocks_per_sm(J)) ln_bwd_kernel(const LnBwd a) {
  constexpr int RPW = 32 / G;  // rows a warp holds at once
  extern __shared__ float red[];  // [NORM_WARPS][3][C]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int li = lane & (G - 1), rg = lane / G;
  const int C = a.C;
  const float invC = 1.0f / (float)C;
  const bool res_f32 = !(a.flags & RES_BF16), g_f32 = a.flags & G_F32, gres_f32 = a.flags & GRES_F32;
  const bool vec = a.vec;

  float acc_g[J][8], acc_b[J][8], acc_d[J][8];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_g[j][e] = acc_b[j][e] = acc_d[j][e] = 0.f;

  for (int pass = blockIdx.x; pass < a.passes; pass += gridDim.x) {
    const int m = pass * (NORM_WARPS * RPW) + warp * RPW + rg;
    const bool live = m < a.M;
    const size_t row = (size_t)(live ? m : 0) * C;
    float x[J][8], g[J][8];
    int valid[J];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c0 = (j * G + li) * NORM_VEC;
      valid[j] = live ? C - c0 : 0;
      if (valid[j] > 0) {
        load8(a.res, row + c0, res_f32, vec, valid[j], x[j]);
        load8(a.g, row + c0, g_f32, vec, valid[j], g[j]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[j][e] = g[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += x[j][e];
    const float mu = group_sum<G>(sum) * invC;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = e < valid[j] ? x[j][e] - mu : 0.f;
        sq += d * d;
      }
    const float r = rsqrtf(group_sum<G>(sq) * invC + a.eps);

    // xhat into x, dxhat = g * gamma into g; dgamma and dbeta as we go
    float sdx = 0.f, sdxx = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (valid[j] <= 0) continue;
      const int c0 = (j * G + li) * NORM_VEC;
      float gam[8];
      load8(a.gamma, c0, true, vec, valid[j], gam);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e >= valid[j]) continue;
        const float xh = (x[j][e] - mu) * r;
        x[j][e] = xh;
        acc_g[j][e] += g[j][e] * xh;
        acc_b[j][e] += g[j][e];
        const float dxh = g[j][e] * gam[e];
        g[j][e] = dxh;
        sdx += dxh;
        sdxx += dxh * xh;
      }
    }
    const float mdx = group_sum<G>(sdx) * invC, mdxx = group_sum<G>(sdxx) * invC;
    const float rs = (a.rscale && live) ? a.rscale[m / a.s_div] : 1.f;

#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (valid[j] <= 0) continue;
      const size_t off = row + (j * G + li) * NORM_VEC;
      float d[8], t[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = r * (g[j][e] - mdx - x[j][e] * mdxx);
      if (a.gres) {
        load8(a.gres, off, gres_f32, vec, valid[j], t);
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] += t[e];
      }
      if (a.dres) store8(a.dres, off, vec, valid[j], d);
      if (a.hmask) {
        load8(a.hmask, off, false, vec, valid[j], t);
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] *= t[e];
      }
      if (a.rscale) {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] *= rs;
      }
      store8(a.da, off, vec, valid[j], d);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < valid[j]) acc_d[j][e] += d[e];
    }
  }

  // fold the warp's row groups (a fixed butterfly), then the warps in order:
  // one partial row [dgamma; dbeta; db] per block
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int o = G; o < 32; o <<= 1) {
        acc_g[j][e] += __shfl_xor_sync(0xffffffffu, acc_g[j][e], o);
        acc_b[j][e] += __shfl_xor_sync(0xffffffffu, acc_b[j][e], o);
        acc_d[j][e] += __shfl_xor_sync(0xffffffffu, acc_d[j][e], o);
      }
  if (rg == 0) {
    float* w = red + (size_t)warp * 3 * C;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c0 = (j * G + li) * NORM_VEC;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c0 + e < C) {
          w[c0 + e] = acc_g[j][e];
          w[C + c0 + e] = acc_b[j][e];
          w[2 * C + c0 + e] = acc_d[j][e];
        }
    }
  }
  __syncthreads();
  float* out = a.part + (size_t)blockIdx.x * 3 * C;
  for (int t = threadIdx.x; t < 3 * C; t += NORM_WARPS * 32) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NORM_WARPS; ++w) v += red[(size_t)w * 3 * C + t];
    out[t] = v;
  }
}

// part[run, c] = sum of x[r, c] (times S[r / s_div], also written to xs) over
// the rows of the run; block (strip, run), thread (row lane, chunk of the strip)
__global__ void __launch_bounds__(COLSUM_THREADS, COLSUM_BLOCKS_PER_SM)
colsum_kernel(const void* __restrict__ x, int x_f32, const float* __restrict__ rscale,
              __nv_bfloat16* __restrict__ xs, float* __restrict__ part, int M, int N, int sc, int rows,
              int s_div, int vec) {
  __shared__ float red[COLSUM_THREADS * NORM_VEC];
  const int RL = COLSUM_THREADS / sc;
  const int cq = threadIdx.x & (sc - 1), rl = threadIdx.x / sc;
  const int c0 = (blockIdx.x * sc + cq) * NORM_VEC;
  const int valid = N - c0;
  const int r0 = blockIdx.y * rows;
  const int r1 = M < r0 + rows ? M : r0 + rows;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (valid > 0) {
    int r = r0 + rl;
    for (; r + (COLSUM_UNROLL - 1) * RL < r1; r += COLSUM_UNROLL * RL) {
      float v[COLSUM_UNROLL][8];
#pragma unroll
      for (int u = 0; u < COLSUM_UNROLL; ++u)
        load8(x, (size_t)(r + u * RL) * N + c0, x_f32, vec, valid, v[u]);
#pragma unroll
      for (int u = 0; u < COLSUM_UNROLL; ++u) {
        if (rscale) {
          const float s = rscale[(r + u * RL) / s_div];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[u][e] *= s;
          store8(xs, (size_t)(r + u * RL) * N + c0, vec, valid, v[u]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += v[u][e];
      }
    }
    for (; r < r1; r += RL) {
      float v[8];
      load8(x, (size_t)r * N + c0, x_f32, vec, valid, v);
      if (rscale) {
        const float s = rscale[r / s_div];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] *= s;
        store8(xs, (size_t)r * N + c0, vec, valid, v);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += v[e];
    }
  }
  // the row lanes in a fixed tree: lane rl takes rl + h, h = RL / 2 .. 1
  float* mine = red + threadIdx.x * NORM_VEC;
#pragma unroll
  for (int e = 0; e < 8; ++e) mine[e] = acc[e];
  for (int h = RL / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (rl < h) {
      const float* other = mine + h * sc * NORM_VEC;
#pragma unroll
      for (int e = 0; e < 8; ++e) mine[e] += other[e];
    }
  }
  __syncthreads();
  if (rl == 0 && valid > 0) {
    float* out = part + (size_t)blockIdx.y * N + c0;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < valid) out[e] = mine[e];
  }
}

// out[c] = sum over p of part[p, c]: warp w takes p = w, w + FOLD_WARPS, ...
// in order, then the warps' sums in order
__global__ void __launch_bounds__(FOLD_WARPS * 32)
fold_kernel(const float* __restrict__ part, float* __restrict__ out, int P, int W) {
  __shared__ float red[FOLD_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (c < W) {
    int p = warp;
    for (; p + 3 * FOLD_WARPS < P; p += 4 * FOLD_WARPS) {
      const float a0 = part[(size_t)p * W + c], a1 = part[(size_t)(p + FOLD_WARPS) * W + c];
      const float a2 = part[(size_t)(p + 2 * FOLD_WARPS) * W + c];
      const float a3 = part[(size_t)(p + 3 * FOLD_WARPS) * W + c];
      v += a0;
      v += a1;
      v += a2;
      v += a3;
    }
    for (; p < P; p += FOLD_WARPS) v += part[(size_t)p * W + c];
  }
  red[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && c < W) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < FOLD_WARPS; ++w) s += red[w][lane];
    out[c] = s;
  }
}

cudaError_t fold(const float* part, float* out, int P, int W, cudaStream_t s) {
  fold_kernel<<<(W + 31) / 32, FOLD_WARPS * 32, 0, s>>>(part, out, P, W);
  return cudaGetLastError();
}

template <int G, int J>
cudaError_t ln_bwd_launch(const LnBwd& a, int blocks, cudaStream_t s) {
  ln_bwd_kernel<G, J><<<blocks, NORM_WARPS * 32, NORM_WARPS * 3 * a.C * sizeof(float), s>>>(a);
  return cudaGetLastError();
}

template <int G>
cudaError_t ln_bwd_chunks(const LnBwd& a, int chunks, int blocks, cudaStream_t s) {
  switch (chunks) {
    case 1: return ln_bwd_launch<G, 1>(a, blocks, s);
    case 2: return ln_bwd_launch<G, 2>(a, blocks, s);
    case 3: return ln_bwd_launch<G, 3>(a, blocks, s);
    case 4: return ln_bwd_launch<G, 4>(a, blocks, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The plan of mvlt_layernorm_bwd for (M, C) on `sms` SMs: out = [lanes,
// chunks, rows_per_block, vec, passes, blocks]; blocks is the scratch's row
// count (part: blocks x 3C f32). Returns -1 (out all 0) for a shape it does
// not take (M < 1, C < 1 or C > 1024).
extern "C" int mvlt_layernorm_bwd_plan(int M, int C, int sms, int* out) {
  LnBwdPlan p = ln_bwd_plan(M, C, sms);
  int v[6] = {p.rows.lanes, p.rows.chunks, p.rows.rows_per_block, p.rows.vec, p.passes, p.blocks};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return p.rows.lanes ? 0 : -1;
}

// sums: (3, C) f32 out = [dgamma; dbeta; db]; hmask, gres, rscale and dres may be null.
// flags: 1 res is bf16 (else f32), 2 g is f32 (else bf16), 4 gres is f32 (else bf16).
// rscale: f32 row scale of da, row m reads rscale[m / s_div]. partials: the
// row count of part, which must be the plan's for (M, C, sms).
extern "C" int mvlt_layernorm_bwd(const void* res, const void* gamma, const void* g, const void* hmask,
                                  const void* gres, const void* rscale, void* dres, void* da, void* part,
                                  void* sums, int M, int C, float eps, int flags, int s_div, int sms,
                                  int partials, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LnBwdPlan p = ln_bwd_plan(M, C, sms);
  if (p.rows.lanes == 0 || p.blocks != partials || (rscale != nullptr && s_div < 1))
    return (int)cudaErrorInvalidValue;
  LnBwd a{res, static_cast<const float*>(gamma), g, static_cast<const __nv_bfloat16*>(hmask), gres,
          static_cast<const float*>(rscale), static_cast<float*>(dres), static_cast<__nv_bfloat16*>(da),
          static_cast<float*>(part), M, C, eps, flags, s_div, p.rows.vec, p.passes};
  cudaError_t e;
  switch (p.rows.lanes) {
    case 1: e = ln_bwd_chunks<1>(a, p.rows.chunks, p.blocks, s); break;
    case 2: e = ln_bwd_chunks<2>(a, p.rows.chunks, p.blocks, s); break;
    case 4: e = ln_bwd_chunks<4>(a, p.rows.chunks, p.blocks, s); break;
    case 8: e = ln_bwd_chunks<8>(a, p.rows.chunks, p.blocks, s); break;
    case 16: e = ln_bwd_chunks<16>(a, p.rows.chunks, p.blocks, s); break;
    case 32: e = ln_bwd_chunks<32>(a, p.rows.chunks, p.blocks, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)fold(a.part, static_cast<float*>(sums), p.blocks, 3 * C, s);
}

// The plan of mvlt_column_sum for an (M, N) input on `sms` SMs: out =
// [strip_chunks, strips, row_chunks, rows, vec]; row_chunks is the
// scratch's row count (part: row_chunks x N f32), run k covering rows
// [k * rows, min(M, (k + 1) * rows)). Returns -1 (out all 0) for M < 1 or N < 1.
extern "C" int mvlt_column_sum_plan(int M, int N, int sms, int* out) {
  ColsumPlan p = colsum_plan(M, N, sms);
  int v[5] = {p.strip_chunks, p.strips, p.row_chunks, p.rows, p.vec};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return p.strip_chunks ? 0 : -1;
}

// rscale (f32, row m reads rscale[m / s_div]) and xs (bf16 (M, N), the scaled copy) are both null or both
// given. partials: the row count of part, which must be the plan's for (M, N, sms).
extern "C" int mvlt_column_sum(const void* x, int x_f32, const void* rscale, void* xs, void* part, void* out,
                               int M, int N, int s_div, int sms, int partials, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ColsumPlan p = colsum_plan(M, N, sms);
  if (p.strip_chunks == 0 || p.row_chunks != partials || (rscale == nullptr) != (xs == nullptr) ||
      (rscale != nullptr && s_div < 1))
    return (int)cudaErrorInvalidValue;
  auto pt = static_cast<float*>(part);
  colsum_kernel<<<dim3(p.strips, p.row_chunks), COLSUM_THREADS, 0, s>>>(
      x, x_f32, static_cast<const float*>(rscale), static_cast<__nv_bfloat16*>(xs), pt, M, N, p.strip_chunks,
      p.rows, s_div, p.vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)fold(pt, static_cast<float*>(out), p.row_chunks, N, s);
}
