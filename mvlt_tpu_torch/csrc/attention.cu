// K2 `biased_attention`: for each (group g, head h)
//   ctx[g, h, i, d] = sum_j softmax_j(scale * (q_i . k_j) + bias_ij) * v_jd
// in bf16, for sm_90a. q, k and v are read, and ctx written, through explicit
// element strides per group, head and row (the head dim is contiguous), so one
// kernel takes two layouts without a copy:
//   packed rows: q, k, v the three C-wide column blocks of fused QKV rows
//     (G*N, 3C) (strides N*3C, Dh, 3C), ctx rows (G*N, C) (N*C, Dh, C): the
//     fused TPU kernels' layout;
//   head-major: q, k, v (G, nH, N, Dh) as `window_attention` (pallas_attn.py
//     :112, body `_kernel` :40) takes them, ctx written as (G, N, nH, Dh) rows
//     that the proj reads without a transpose.
//
//   bias_ij = pattern[g % P, h, i, j]   (optional; the Swin relative-position
//                                        bias, with the -100 shift mask folded
//                                        in for SW-MSA blocks)
//           + kbias[g, j]               (optional; BERT key padding, -10000)
//           + qbias[g, i, j]            (optional; the seq2seq / UniLM mask,
//                                        per sample, shared by the heads)
// and, optionally, the softmax output is multiplied by amask[g, h, i, j] (the
// attention-dropout mask, 0 or 1/keep, bf16) before p is rounded to bf16 for
// the PV product: the interpret path of `_attn_ln_kernel` :2220-2233.
//
// Two opt-in modes:
// (a) in-kernel dropout (`fused_attn_ln_adrop` :2770, `_adrop_mask` :2133):
//     from a (2,) int32 seed in device memory, the kernel draws the mask of
//     element (g, h, i, j) with Philox (philox.cuh; g is the absolute sample)
//     and multiplies the f32 softmax by it (0 or f32(1/keep)) where amask
//     enters; `mask_out` (G, nH, N, N) f32, when given, receives the mask it
//     drew (`save_amask` :2161, a debug output);
// (b) stored p (`_full_kernel_save_p` :774 and the other `_save_p` kernels):
//     `p_out` (G, nH, N, N) receives the normalised softmax (exact divide,
//     before any dropout mask) rounded to bf16, the p that the PV product
//     uses, for K4's stored-p backward.
//
// Replaces the attention core of the TPU kernels in
// mvlt_tpu/ops/pallas_attn.py: `_attend` (:512) as called from `_full_body`
// (`_full_kernel`, `_full_shift_kernel`), `_block_kernel`, `_attn_ln_kernel`,
// `_attn_half_kernel`, `_seq_attn_kernel` and `_full_kernel_windows`, and
// the whole of `_kernel` (`window_attention`). It holds their exact
// (interpret-mode) math at the same rounding points: scores in f32 (the bf16
// products are exact in f32; `scale` multiplies the f32 sum, as JAX's bf16
// path orders it, :535-537), a max-subtracted softmax with an exact divide,
// probabilities rounded to bf16 before the PV product, PV accumulated in f32,
// ctx rounded once to bf16. No atomics: two calls agree bitwise.
//
// Bound: at the shapes the port runs (N 49-288, Dh 32 / 64) a (group, head)
// does 4 N^2 Dh flop against reading q, k, v once and writing ctx once, some
// 30-110 flop per byte: far below the tensor cores' 295, so the kernel is
// bound by bytes, and beside them by the per-score work of the softmax (bias
// loads, exp, the divide, in mode (a) a Philox draw) and by the latency of
// each block's chain of copies, products and reductions. The design (it
// replaces a scalar-FMA kernel that held one N x N f32 tile per block in
// shared memory and stopped at N = 162):
//   - one block is one warpgroup (128 threads) and owns 64 query rows of one
//     (group, head): grid (ceil(N / 64) tiles) x nH x G, so small windows
//     (N = 49) give thousands of small blocks; a register cap per chunk count
//     (`min_blocks`) keeps 2-6 of them on each SM to hide each other's
//     latency;
//   - q (its 64 rows), k and v (all N keys, padded to a multiple of 32) are
//     copied once into shared memory as bf16 by cp.async, 16 bytes a thread,
//     in rows of one swizzle width (Dh 32: 64-byte rows, 64-byte swizzle;
//     Dh 64: 128-byte rows, 128-byte swizzle; Dh 16 / 48 are zero-padded to
//     32 / 64 columns); rows past N arrive as zeros. v (and an amask's rows)
//     are a second copy group, which lands while S is computed. An amask
//     tile (64 rows of N bf16) is one contiguous span of device memory and is
//     staged whole where it keeps the blocks per SM (N <= 221 at Dh 64);
//   - mode (a)'s keep bits are drawn while the copies are in flight, one
//     Philox call for two scores (a row quad's four lanes share their words);
//   - S = Q K^T runs on the tensor cores as ceil(N / 32) wgmma.m64n32k16
//     products per k16 step, both operands K-major in shared memory; the f32
//     scores stay in registers (N <= 288: at most 144 a thread);
//   - scale, the bias terms and the masks are applied per accumulator element
//     from its (row, column) in the wgmma layout; keys past N are -inf; the
//     row max and row sum are reduced over the four threads of a row with
//     shuffles; the divide is exact (correctly rounded, as v / sum); p_out
//     and mask_out are written from those registers;
//   - P V runs as wgmma.m64n{32,64}k16 with A in registers: the bf16 p of a
//     16-key step is, pair for pair, the accumulator layout of S; V is read
//     MN-major from shared memory through the transpose bit;
//   - ctx is staged as bf16 through q's shared memory (q is read by then) and
//     written as 16-byte stores through the output strides.
// That register-resident tiling stops at N = 288: the scores' registers,
// not shared memory (82,944 bytes at N = 288, Dh 64; `smem_bytes` below,
// mirrored by ops/kernels.py).
//
// The long form (`attention_long_kernel`, N > 288): JAX's fused encoder has
// no length gate (mvlt_tpu/models/fusion.py:105-117), so `_attn_ln_kernel`
// runs at S = 348 (ViT-B/16 or the linear patch with MIMIC-CXR's 150 text
// tokens) and 474 (two IU X-Ray views). One warpgroup still owns 64 query
// rows of a (group, head), but the keys stream through a two-stage ring of
// 64-key chunks (k, and in the second sweep v, by cp.async: the next chunk
// lands while one is used), so neither shared memory (41,984 bytes at Dh
// 64, 21,504 at Dh 32) nor registers grow with N. Two sweeps over the
// chunks:
//   1. S = Q K_c^T, scale and biases, then each row's max and its sum of
//      exponentials. The sum is kept against the running max and rescaled
//      by exp(old max - new max) when the max grows, so it is the sum
//      against the row's final max up to that rescaling's rounding;
//   2. S again, p = exp(s - max) / sum with the exact divide, times the
//      amask (read from device memory score by score: 64 rows of N bf16
//      cannot be staged beside the ring at these N) or the Philox keep mask
//      (drawn per 32-key chunk as the register form draws it), rounded to
//      bf16 and accumulated as P V_c in f32.
// Why not FlashAttention's one-pass rescaled accumulator: the two sweeps
// keep the rounding points that the register form and JAX's interpret path
// share (p normalised in f32 before its bf16 rounding, PV summed once); the
// kernel is bound by bytes, so the second Q K^T costs little. It takes the
// sequence modes only (key bias, qbias, amask, in-kernel dropout): the
// pattern and stored-p modes keep the register form and its N <= 288, and
// the wrapper keeps the head-major layout there too (no path runs a window
// past 144). N is capped at 46,340 so that i * N + j stays a 32-bit index
// (and a 32-bit Philox counter word).
//
// The loader needs 16-byte aligned q, k, v, ctx and strides that are
// multiples of 8 elements (checked by the wrapper and here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "philox.cuh"

namespace {

using namespace mvlt;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;              // one warpgroup
constexpr int ROWS = 64;                  // query rows a tile: one wgmma's M
constexpr int KEYS = 32;                  // keys a chunk of S: one m64n32 product
constexpr int MAX_CHUNKS = 9;             // S in 9 x 16 f32 registers a thread
constexpr int MAX_N = MAX_CHUNKS * KEYS;  // 288

// shared-memory columns of a row: the head dim padded to one swizzle row
__host__ __device__ constexpr int head_cols(int Dh) { return Dh <= 32 ? 32 : 64; }

// blocks an SM should hold for NC key chunks: the register cap that lets the
// scheduler hide the bias / mask loads behind other blocks (at NC 5 a cap of
// 168 registers beat the uncapped 216 by 1.4x on an H100); from 7 chunks on
// the scores take up to 255 registers
__host__ __device__ constexpr int min_blocks(int nc) {
  return nc <= 2 ? 6 : nc <= 3 ? 5 : nc <= 4 ? 4 : nc <= 6 ? 3 : 2;
}
// shared memory an H100 SM gives its blocks (228 KB), and what it keeps of it
// for each block
constexpr int SM_SMEM = 233472, BLOCK_RESERVED = 1024;

__host__ __device__ constexpr bool takes(int N, int Dh) {
  return N >= 1 && N <= MAX_N && Dh >= 16 && Dh <= 64 && Dh % 16 == 0;
}
// q's 64 rows, k and v padded to whole chunks, slack for the 1024-byte
// alignment of the swizzle
__host__ __device__ constexpr int base_bytes(int N, int Dh) {
  return (ROWS + 2 * ((N + KEYS - 1) / KEYS) * KEYS) * head_cols(Dh) * 2 + 1024;
}
// an amask's rows of one tile, 64 rows of N bf16 in one contiguous span (and
// the 16 bytes by which its first 16-byte chunk may start before it), are
// staged in shared memory where that keeps min_blocks blocks on an SM; else
// they are read from device memory score by score
__host__ __device__ constexpr int mask_bytes(int N, int Dh) {
  return base_bytes(N, Dh) + ROWS * N * 2 + 16 <=
                 SM_SMEM / min_blocks((N + KEYS - 1) / KEYS) - BLOCK_RESERVED
             ? ROWS * N * 2 + 16
             : 0;
}
// the long form: keys a ring chunk (two m64n32 products), its stages, the
// largest N (i * N + j in 32 bits), blocks an SM
constexpr int LONG_KEYS = 64, LONG_SUB = LONG_KEYS / KEYS, LONG_STAGES = 2;
constexpr int LONG_MAX_N = 46340;
constexpr int LONG_MIN_BLOCKS = 3;
__host__ __device__ constexpr bool long_takes(int N, int Dh) {
  return N > MAX_N && N <= LONG_MAX_N && Dh >= 16 && Dh <= 64 && Dh % 16 == 0;
}
// q's 64 rows, the ring's k and v chunks, slack for the swizzle's alignment
__host__ __device__ constexpr int long_bytes(int Dh) {
  return (ROWS + LONG_STAGES * 2 * LONG_KEYS) * head_cols(Dh) * 2 + 1024;
}
// shared memory of one block, or -1 where the kernel does not take (N, Dh)
__host__ __device__ constexpr long long smem_bytes(int N, int Dh, bool amask) {
  return takes(N, Dh) ? base_bytes(N, Dh) + (amask ? mask_bytes(N, Dh) : 0)
         : long_takes(N, Dh) ? long_bytes(Dh)
                             : -1;
}

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long in_g, in_h, in_n, out_g, out_h, out_n;
  const float* pattern;
  const float* kbias;
  const float* qbias;
  const bf16* amask;
  const int* seed;
  bf16* ctx;
  bf16* p_out;
  float* mask_out;
  int N, nH, Dh, P, tiles;
  int mask_staged;  // amask rows in shared memory (mask_bytes > 0)
  float scale;
  uint32_t thresh;
  float kept;
};

template <int NC, int DP>
__global__ void __launch_bounds__(THREADS, min_blocks(NC)) attention_wgmma_kernel(const Params p) {
  constexpr int ROWB = DP * 2;
  constexpr int KR = NC * KEYS;
  constexpr uint64_t SW = DP == 64 ? SWIZZLE_128B : SWIZZLE_64B;
  constexpr uint32_t SBO = 8 * ROWB;  // 8-row groups of every operand
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* Ks = Qs + ROWS * ROWB;
  unsigned char* Vs = Ks + KR * ROWB;
  unsigned char* Ms = Vs + KR * ROWB;  // the amask rows, when given

  const int N = p.N;
  const int tile = blockIdx.x % p.tiles;
  const int gh = blockIdx.x / p.tiles;
  const int h = gh % p.nH, g = gh / p.nH;
  const int row0 = tile * ROWS;
  const long long in0 = g * p.in_g + h * p.in_h;
  const size_t nn = (size_t)N * N;
  const size_t t0 = ((size_t)g * p.nH + h) * nn;  // (g, h)'s N x N block of amask, p_out, mask_out

  load_rows<ROWB>(Qs, p.q, in0, p.in_n, row0, ROWS, N, p.Dh);
  load_rows<ROWB>(Ks, p.k, in0, p.in_n, 0, KR, N, p.Dh);
  cp_async_commit();
  load_rows<ROWB>(Vs, p.v, in0, p.in_n, 0, KR, N, p.Dh);
  // the tile's amask rows are one span of (g, h)'s block: the 16-byte chunks
  // that cover it, the first from the aligned address at or before it, the
  // last cut at its end (the tensor starts on a 16-byte boundary)
  uintptr_t m_lo = 0;
  if (p.mask_staged)
    m_lo = stage_span(Ms, reinterpret_cast<uintptr_t>(p.amask + t0 + (size_t)row0 * N),
                      reinterpret_cast<uintptr_t>(p.amask + t0 + (size_t)min(row0 + ROWS, N) * N));
  cp_async_commit();

  // the softmax on the fragments. Element x of chunk c sits in row r0 + 8 hh,
  // column cq + col with x = 4 b + 2 hh + e and col = 32 c + 8 b + e, a
  // constant once the loops unroll: each bias, mask or output is read or
  // written at a per-row offset (i * N + cq) plus that constant, so no
  // element keeps an address of its own. A warp whose 16 rows are all past
  // N (warp-uniform) skips the work.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const bool live_warp = row0 + warp * 16 < N;
  const bool live0 = row0 + r0 < N, live1 = row0 + r0 + 8 < N;
  // i * N of the two rows (signed: never wraps, so base + constant folds into
  // the address)
  const int erow0 = (row0 + r0) * N, erow1 = (row0 + r0 + 8) * N;
  auto col = [](int c, int x) { return c * KEYS + (x >> 2) * 8 + (x & 1); };

  // (a): bit x of keep[c] keeps element x of chunk c, drawn while the copies
  // are in flight (it needs only g, h and the element's place)
  uint32_t keep[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) keep[c] = 0;
  if (p.seed && live_warp) {
    float* mo = p.mask_out ? p.mask_out + t0 : nullptr;
    const uint32_t key = adrop_key(p.seed), ctr1 = (uint32_t)g * 256u + (uint32_t)h;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      keep[c] = draw_chunk(c * KEYS, erow0, erow1, live0, live1, cq, lane, N, key, ctr1, p.thresh, p.kept, mo);
  }
  cp_async_wait<1>();  // q and k are in
  fence_proxy_async();
  __syncthreads();

  // S = Q K^T, f32 in registers
  float s[NC][16];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int x = 0; x < 16; ++x) s[c][x] = 0.f;
    fence_acc(s[c]);
  }
  wgmma_fence();
  const uint32_t q_base = smem_u32(Qs), k_base = smem_u32(Ks);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)  // a k16 step: 32 bytes along a row
      wgmma_m64n32k16(s[c], make_desc(q_base + kk * 32, 16, SBO, SW),
                      make_desc(k_base + c * KEYS * ROWB + kk * 32, 16, SBO, SW));
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_acc(s[c]);

  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  if (live_warp) {
    const float* pb = p.pattern ? p.pattern + ((size_t)(g % p.P) * p.nH + h) * nn : nullptr;
    const float* kb = p.kbias ? p.kbias + (size_t)g * N + cq : nullptr;
    const float* qb = p.qbias ? p.qbias + (size_t)g * nn : nullptr;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int hh = (x >> 1) & 1, j = col(c, x);
        const int e = (hh ? erow1 : erow0) + cq + j;
        float v = -INFINITY;  // keys past N
        if (cq + j < N) {
          v = s[c][x] * p.scale;
          if (hh ? live1 : live0) {
            if (pb) v += __ldg(pb + e);
            if (kb) v += __ldg(kb + j);
            if (qb) v += __ldg(qb + e);
          }
        }
        s[c][x] = v;
        mx[hh] = fmaxf(mx[hh], v);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int hh = (x >> 1) & 1;
        s[c][x] = expf(s[c][x] - mx[hh]);
        sum[hh] += s[c][x];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
    }
  }
  if (p.mask_staged) {  // the amask rows (and v) are in
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
  }

  uint32_t a[NC][2][4];  // p in bf16: the A operand of P V, per 16-key step
  if (live_warp) {
    bf16* po = p.p_out ? p.p_out + t0 : nullptr;
    // element e of (g, h)'s amask block sits m_base + 2 e bytes into Ms
    const int m_base = p.mask_staged ? (int)((long long)reinterpret_cast<uintptr_t>(p.amask + t0) - (long long)m_lo) : 0;
    const bf16* am = p.amask ? p.amask + t0 : nullptr;
    // the exact divide v / sum as Markstein's correction of v * RN(1 / sum):
    // q0 = RN(v * r), then RN(q0 + RN(v - q0 * sum) * r) is the correctly
    // rounded quotient (no IEEE-divide branch per score)
    const float rcp[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int hh = (x >> 1) & 1, j = col(c, x);
        const float q0 = s[c][x] * rcp[hh];
        float v = fmaf(fmaf(-q0, sum[hh], s[c][x]), rcp[hh], q0);
        if ((hh ? live1 : live0) && cq + j < N) {
          const int e = (hh ? erow1 : erow0) + cq + j;
          if (po) po[e] = __float2bfloat16(v);  // (b): before any dropout mask
          if (am)
            v *= __bfloat162float(p.mask_staged ? *reinterpret_cast<const bf16*>(Ms + m_base + 2 * e)
                                                : __ldg(am + e));
          if (p.seed) v *= (keep[c] >> x) & 1 ? p.kept : 0.f;
        }
        s[c][x] = v;
      }
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16) {
#pragma unroll
        for (int q = 0; q < 4; ++q) a[c][k16][q] = pack_bf16(s[c][8 * k16 + 2 * q], s[c][8 * k16 + 2 * q + 1]);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16)
#pragma unroll
        for (int q = 0; q < 4; ++q) a[c][k16][q] = 0u;
  }

  // O = P V: A from registers, V MN-major (its Dh columns contiguous)
  if (!p.mask_staged) {  // v is in
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
  }
  float o[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
  fence_acc(o);
  wgmma_fence();
  const uint32_t v_base = smem_u32(Vs);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int k16 = 0; k16 < 2; ++k16) {
      // 16 key rows; one column block, so LBO is unused (given SBO's value)
      const uint64_t dv = make_desc(v_base + (c * KEYS + k16 * 16) * ROWB, SBO, SBO, SW);
      if constexpr (DP == 64)
        wgmma_m64n64k16_rs(o, a[c][k16], dv);
      else
        wgmma_m64n32k16_rs(o, a[c][k16], dv);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(o);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int k16 = 0; k16 < 2; ++k16) fence_regs(a[c][k16]);

  // ctx: bf16 pairs into q's rows (no wgmma reads q any more), then 16-byte
  // stores of the rows below N through the output strides
#pragma unroll
  for (int b = 0; b < DP / 8; ++b) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(Qs + swz<ROWB>(r0 + 8 * hh, b) + cq * 2) =
          pack_bf16(o[4 * b + 2 * hh], o[4 * b + 2 * hh + 1]);
  }
  __syncthreads();
  const long long out0 = g * p.out_g + h * p.out_h;
  const int chunks = p.Dh / 8;
  for (int e = threadIdx.x; e < ROWS * chunks; e += THREADS) {
    const int r = e / chunks, c = e % chunks;
    const int i = row0 + r;
    if (i < N)
      *reinterpret_cast<uint4*>(p.ctx + out0 + i * p.out_n + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<ROWB>(r, c));
  }
}

// The long form (N > 288): 64 query rows of one (group, head) against the
// keys streamed in 64-key chunks, two sweeps (see the head of the file).
// Step t of the 2 * nch steps is chunk t % nch of sweep t / nch; its copies
// land in ring stage t % 2 while step t - 1 computes.
template <int DP>
__global__ void __launch_bounds__(THREADS, LONG_MIN_BLOCKS) attention_long_kernel(const Params p) {
  constexpr int ROWB = DP * 2;
  constexpr uint64_t SW = DP == 64 ? SWIZZLE_128B : SWIZZLE_64B;
  constexpr uint32_t SBO = 8 * ROWB;
  constexpr int STAGE = 2 * LONG_KEYS * ROWB;  // a chunk's k rows, then its v rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* Ring = Qs + ROWS * ROWB;

  const int N = p.N;
  const int tile = blockIdx.x % p.tiles;
  const int gh = blockIdx.x / p.tiles;
  const int h = gh % p.nH, g = gh / p.nH;
  const int row0 = tile * ROWS;
  const long long in0 = g * p.in_g + h * p.in_h;
  const size_t nn = (size_t)N * N;
  const size_t t0 = ((size_t)g * p.nH + h) * nn;
  const int nch = (N + LONG_KEYS - 1) / LONG_KEYS;

  // the copies of step t: k of its chunk, and in the second sweep v
  auto prefetch = [&](int t) {
    const int key0 = (t < nch ? t : t - nch) * LONG_KEYS;
    unsigned char* st = Ring + (t & 1) * STAGE;
    load_rows<ROWB>(st, p.k, in0, p.in_n, key0, LONG_KEYS, N, p.Dh);
    if (t >= nch) load_rows<ROWB>(st + LONG_KEYS * ROWB, p.v, in0, p.in_n, key0, LONG_KEYS, N, p.Dh);
  };
  load_rows<ROWB>(Qs, p.q, in0, p.in_n, row0, ROWS, N, p.Dh);
  prefetch(0);
  cp_async_commit();

  // element x of sub-chunk c sits in row r0 + 8 hh, column c0 + cq + col(c, x)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const bool live_warp = row0 + warp * 16 < N;
  const bool live0 = row0 + r0 < N, live1 = row0 + r0 + 8 < N;
  const int erow0 = (row0 + r0) * N, erow1 = (row0 + r0 + 8) * N;
  auto col = [](int c, int x) { return c * KEYS + (x >> 2) * 8 + (x & 1); };
  const float* kb = p.kbias ? p.kbias + (size_t)g * N + cq : nullptr;
  const float* qb = p.qbias ? p.qbias + (size_t)g * nn : nullptr;
  const bf16* am = p.amask ? p.amask + t0 : nullptr;
  float* mo = p.mask_out ? p.mask_out + t0 : nullptr;
  const uint32_t key = p.seed ? adrop_key(p.seed) : 0u, ctr1 = (uint32_t)g * 256u + (uint32_t)h;

  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, rcp[2] = {0.f, 0.f};
  float o[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
  fence_acc(o);
  const uint32_t q_base = smem_u32(Qs);

#pragma unroll 1
  for (int t = 0; t < 2 * nch; ++t) {
    __syncthreads();  // every warp is done with stage (t + 1) % 2, step t - 1's
    if (t + 1 < 2 * nch) prefetch(t + 1);
    cp_async_commit();  // (an empty group at the last step keeps the count)
    const bool second = t >= nch;
    const int c0 = (second ? t - nch : t) * LONG_KEYS;
    // the keep bits of the second sweep's chunk, drawn while its copies fly
    uint32_t keep[LONG_SUB];
#pragma unroll
    for (int c = 0; c < LONG_SUB; ++c) keep[c] = 0;
    if (second && p.seed && live_warp) {
#pragma unroll
      for (int c = 0; c < LONG_SUB; ++c)
        keep[c] = draw_chunk(c0 + c * KEYS, erow0, erow1, live0, live1, cq, lane, N, key, ctr1, p.thresh,
                             p.kept, mo);
    }
    cp_async_wait<1>();  // step t's copies are in
    fence_proxy_async();
    __syncthreads();

    const uint32_t k_base = smem_u32(Ring + (t & 1) * STAGE), v_base = k_base + LONG_KEYS * ROWB;
    float s[LONG_SUB][16];
#pragma unroll
    for (int c = 0; c < LONG_SUB; ++c) {
#pragma unroll
      for (int x = 0; x < 16; ++x) s[c][x] = 0.f;
      fence_acc(s[c]);
    }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < LONG_SUB; ++c) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_m64n32k16(s[c], make_desc(q_base + kk * 32, 16, SBO, SW),
                        make_desc(k_base + c * KEYS * ROWB + kk * 32, 16, SBO, SW));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < LONG_SUB; ++c) fence_acc(s[c]);

    if (live_warp) {  // scale and biases; keys past N are -inf
#pragma unroll
      for (int c = 0; c < LONG_SUB; ++c) {
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          const int hh = (x >> 1) & 1, j = c0 + col(c, x);
          float v = -INFINITY;
          if (cq + j < N) {
            v = s[c][x] * p.scale;
            if (hh ? live1 : live0) {
              if (kb) v += __ldg(kb + j);
              if (qb) v += __ldg(qb + (hh ? erow1 : erow0) + cq + j);
            }
          }
          s[c][x] = v;
        }
      }
    }

    if (!second) {
      if (live_warp) {
        // the chunk's row max over the quad, then the running sum rescaled
        // to the new max (every chunk holds a key below N: the max is finite)
        float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int c = 0; c < LONG_SUB; ++c)
#pragma unroll
          for (int x = 0; x < 16; ++x) cm[(x >> 1) & 1] = fmaxf(cm[(x >> 1) & 1], s[c][x]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          cm[hh] = fmaxf(cm[hh], __shfl_xor_sync(0xffffffffu, cm[hh], 1));
          cm[hh] = fmaxf(cm[hh], __shfl_xor_sync(0xffffffffu, cm[hh], 2));
          const float nm = fmaxf(mx[hh], cm[hh]);
          if (nm > mx[hh]) sum[hh] *= expf(mx[hh] - nm);  // 0 before the first chunk
          mx[hh] = nm;
        }
#pragma unroll
        for (int c = 0; c < LONG_SUB; ++c)
#pragma unroll
          for (int x = 0; x < 16; ++x) sum[(x >> 1) & 1] += expf(s[c][x] - mx[(x >> 1) & 1]);
        if (t == nch - 1) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
            sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
            rcp[hh] = __frcp_rn(sum[hh]);
          }
        }
      }
      continue;
    }

    // the second sweep: p = exp(s - max) / sum (Markstein's exact divide, as
    // the register form), the dropout multiplier, bf16 pairs for P V
    uint32_t a[LONG_SUB][2][4];
    if (live_warp) {
#pragma unroll
      for (int c = 0; c < LONG_SUB; ++c) {
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          const int hh = (x >> 1) & 1, j = c0 + col(c, x);
          const float ex = expf(s[c][x] - mx[hh]);
          const float q0 = ex * rcp[hh];
          float v = fmaf(fmaf(-q0, sum[hh], ex), rcp[hh], q0);
          if ((hh ? live1 : live0) && cq + j < N) {
            if (am) v *= __bfloat162float(__ldg(am + (hh ? erow1 : erow0) + cq + j));
            if (p.seed) v *= (keep[c] >> x) & 1 ? p.kept : 0.f;
          }
          s[c][x] = v;
        }
#pragma unroll
        for (int k16 = 0; k16 < 2; ++k16)
#pragma unroll
          for (int q = 0; q < 4; ++q) a[c][k16][q] = pack_bf16(s[c][8 * k16 + 2 * q], s[c][8 * k16 + 2 * q + 1]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < LONG_SUB; ++c)
#pragma unroll
        for (int k16 = 0; k16 < 2; ++k16)
#pragma unroll
          for (int q = 0; q < 4; ++q) a[c][k16][q] = 0u;
    }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < LONG_SUB; ++c) {
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16) {
        const uint64_t dv = make_desc(v_base + (c * KEYS + k16 * 16) * ROWB, SBO, SBO, SW);
        if constexpr (DP == 64)
          wgmma_m64n64k16_rs(o, a[c][k16], dv);
        else
          wgmma_m64n32k16_rs(o, a[c][k16], dv);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();  // the stage is free for step t + 2's copies
    fence_acc(o);
#pragma unroll
    for (int c = 0; c < LONG_SUB; ++c)
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16) fence_regs(a[c][k16]);
  }

  // ctx through q's rows, as the register form writes it
  __syncthreads();
#pragma unroll
  for (int b = 0; b < DP / 8; ++b) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(Qs + swz<ROWB>(r0 + 8 * hh, b) + cq * 2) =
          pack_bf16(o[4 * b + 2 * hh], o[4 * b + 2 * hh + 1]);
  }
  __syncthreads();
  const long long out0 = g * p.out_g + h * p.out_h;
  const int chunks = p.Dh / 8;
  for (int e = threadIdx.x; e < ROWS * chunks; e += THREADS) {
    const int r = e / chunks, c = e % chunks;
    const int i = row0 + r;
    if (i < N)
      *reinterpret_cast<uint4*>(p.ctx + out0 + i * p.out_n + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<ROWB>(r, c));
  }
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

template <int NC, int DP>
cudaError_t launch(const Params& p, long long blocks, int smem, cudaStream_t stream) {
  // the most any N of this instance asks (a staged amask at N <= 32 NC)
  constexpr int most = (ROWS + 2 * NC * KEYS) * DP * 2 + 1024 + ROWS * NC * KEYS * 2 + 16;
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(attention_wgmma_kernel<NC, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  attention_wgmma_kernel<NC, DP><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dispatch(int chunks, const Params& p, long long blocks, int smem, cudaStream_t stream) {
  switch (chunks) {
    case 1: return launch<1, DP>(p, blocks, smem, stream);
    case 2: return launch<2, DP>(p, blocks, smem, stream);
    case 3: return launch<3, DP>(p, blocks, smem, stream);
    case 4: return launch<4, DP>(p, blocks, smem, stream);
    case 5: return launch<5, DP>(p, blocks, smem, stream);
    case 6: return launch<6, DP>(p, blocks, smem, stream);
    case 7: return launch<7, DP>(p, blocks, smem, stream);
    case 8: return launch<8, DP>(p, blocks, smem, stream);
    case 9: return launch<9, DP>(p, blocks, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}
static_assert(MAX_CHUNKS == 9, "dispatch covers every chunk count");

template <int DP>
cudaError_t launch_long(const Params& p, long long blocks, cudaStream_t stream) {
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(attention_long_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         long_bytes(DP));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  attention_long_kernel<DP><<<static_cast<unsigned>(blocks), THREADS, long_bytes(DP), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The shared memory a block may opt in to on the current device (-1 if the query failed).
extern "C" int mvlt_smem_optin(void) { return smem_optin(); }

// Shared memory one block needs for (N, Dh), with or without an amask, or -1 where the kernel does not
// take them (N outside 1 .. 46,340, or a head dim that is not 16, 32, 48 or 64); past N = 288 the long
// form's, which does not grow with N. The wrapper checks it against the card's opt-in limit.
extern "C" long long mvlt_attention_smem(int N, int Dh, int amask) { return smem_bytes(N, Dh, amask != 0); }

// q, k, v: bf16, element (g, h, n, d) at g * in_g + h * in_h + n * in_n + d; ctx: bf16, element
// (g, h, i, d) at g * out_g + h * out_h + i * out_n + d; all four 16-byte aligned, every stride a
// multiple of 8. pattern (P, nH, N, N) f32, kbias (G, N) f32, qbias (G, N, N) f32 and amask
// (G, nH, N, N) bf16 may each be null. seed: null, or (2,) int32 16-bit halves for mode (a), which
// keeps an element iff its Philox word < thresh and then multiplies by kept; amask must be null with
// it, and nH <= 256. p_out (G, nH, N, N) bf16 (mode (b)) and mask_out (G, nH, N, N) f32 (mode (a)
// only) may be null. Past N = 288 (the long form) pattern and p_out must be null.
extern "C" int mvlt_attention(const void* q, const void* k, const void* v, long long in_g, long long in_h,
                              long long in_n, void* ctx, long long out_g, long long out_h, long long out_n,
                              const void* pattern, const void* kbias, const void* qbias, const void* amask,
                              const void* seed, void* p_out, void* mask_out, int G, int N, int nH, int Dh,
                              int P, float scale, unsigned int thresh, float kept, void* stream) {
  const long long smem = smem_bytes(N, Dh, amask != nullptr);
  if (smem < 0 || G < 1 || nH < 1 || P < 1) return (int)cudaErrorInvalidValue;
  if (seed != nullptr && (amask != nullptr || nH > 256)) return (int)cudaErrorInvalidValue;
  if (mask_out != nullptr && seed == nullptr) return (int)cudaErrorInvalidValue;
  const bool long_form = N > MAX_N;
  if (long_form && (pattern != nullptr || p_out != nullptr)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)ctx) & 15) return (int)cudaErrorInvalidValue;
  if ((in_g | in_h | in_n | out_g | out_h | out_n) & 7) return (int)cudaErrorInvalidValue;
  const int optin = smem_optin();
  if (optin < 0 || smem > optin) return (int)cudaErrorInvalidValue;
  const int tiles = (N + ROWS - 1) / ROWS;
  const long long blocks = (long long)G * nH * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  using cbf = const bf16*;
  const Params p{static_cast<cbf>(q), static_cast<cbf>(k), static_cast<cbf>(v), in_g, in_h, in_n,
                 out_g, out_h, out_n, static_cast<const float*>(pattern), static_cast<const float*>(kbias),
                 static_cast<const float*>(qbias), static_cast<cbf>(amask), static_cast<const int*>(seed),
                 static_cast<bf16*>(ctx), static_cast<bf16*>(p_out), static_cast<float*>(mask_out), N, nH,
                 Dh, P, tiles, !long_form && amask != nullptr && mask_bytes(N, Dh) > 0, scale, thresh, kept};
  const int chunks = (N + KEYS - 1) / KEYS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (long_form)
    return (int)(head_cols(Dh) == 64 ? launch_long<64>(p, blocks, s) : launch_long<32>(p, blocks, s));
  return (int)(head_cols(Dh) == 64 ? dispatch<64>(chunks, p, blocks, (int)smem, s)
                                   : dispatch<32>(chunks, p, blocks, (int)smem, s));
}
