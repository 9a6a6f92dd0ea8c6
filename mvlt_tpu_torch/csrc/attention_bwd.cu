// K4 `biased_attention_bwd`: the VJP of the per-group attention core
//   ctx = (softmax(q k^T * scale + pattern[g % P] + kbias + qbias) * amask) v   (per group g, head h)
// with respect to the fused QKV rows, the key bias and the bias patterns, for sm_90a.
//
// Replaces `_seq_core_bwd_kernel` (mvlt_tpu/ops/pallas_attn.py:2413, entry
// `seq_attention_core_bwd` :2536), the windowed cores `_core_bwd_kernel2d`
// (:3782, entry `attention_core_bwd_flat` :3898), `_core_bwd_kernel` (:3637,
// entry `attention_core_bwd` :4067) and `_core_bwd_storep_kernel` (:3859),
// and the XLA backwards `_bwd` (:128) and `_seq_bwd` (:440) that the port
// routes here. For each (g, h), from the saved QKV rows (G*N, 3C) and dctx
// (G*N, C) in bf16:
//   s  = (q k^T) * scale + pattern[g % P, h] + kbias[g] + qbias[g]  (recomputed; each optional)
//   p  = exp(s - max_j s) / sum_j exp(...)      (exact divide)
//   pa = p * amask[g, h]                        (optional dropout mask, 0 or 1/keep)
//   dv = pa^T dctx,  dp = (dctx v^T) * amask[g, h]
//   ds = p * dp - p * rowsum(p * dp)
//   dq = (ds k) * scale,  dk = (ds^T q) * scale
// dqkv is written in bf16; dkbias[g, j] = sum over heads and rows i of
// ds[i, j], and dpattern[p, h] = sum of ds over the G / P groups g with
// g % P == p (the Swin windows that share a relative-position / shift-mask
// pattern), both in f32. Two opt-in modes: (a) regenerated dropout
// (`adrop_rate`, :2485): the mask is redrawn from the (2,) int32 device seed
// with K2's Philox stream (philox.cuh), bit for bit; (b) stored p
// (`_core_bwd_from_p` :3747-3770): p (G, nH, N, N) bf16, saved by K2's mode
// (b), is read in place of the recompute, and no key bias or pattern enters
// it (dkbias and dpattern are written as before).
//
// Numerics: the products run on the tensor cores with bf16 operands and f32
// sums. s, the softmax, rowsum(p * dp), ds and every sum stay f32; ds and pa
// are rounded to bf16 where they enter dq / dk / dv (JAX's fast path rounds
// them there too, `pa_d`, `dsd`); dkbias and dpattern sum the f32 ds. No
// atomics and one fixed order for every sum: two calls agree bitwise.
//
// Bound: at the shapes the port runs (N 49-288, Dh 32 / 64) a (g, h) needs
// 10 N^2 Dh flop (five products) against one read of q, k, v, dctx and the
// masks and one write of dq, dk, dv: 50-90 flop per byte without masks, far
// below the tensor cores' 295, so the kernel is bound by bytes, and beside
// them by the per-score work (bias and mask loads, exp, the divide) and by
// the latency of each block's chain of copies, products and reductions. The
// design follows the deterministic split of FlashAttention-2's backward into
// two passes, each on one warpgroup (128 threads) a block:
//   - pass 1, `attention_bwd_dq_kernel`, tiles the queries as K2 does (64
//     rows a block, grid tiles x nH x G): q's and dctx's 64 rows, every
//     key's k and v and, where they fit, the amask's 64 rows are copied to
//     (swizzled) shared memory by cp.async; S = Q K^T (wgmma.m64n32k16,
//     both operands K-major) stays in registers (16 f32 a thread per 32-key
//     chunk), the softmax runs on the fragments as in K2 and leaves p
//     there. Up to BATCH_CHUNKS chunks, dp = dO V^T runs for every chunk in
//     one commit group beside S (one wait, as K2 waits once for S); ds
//     replaces p in place, and its bf16 pairs are the register A operands
//     of dq = ds K (K read MN-major through the transpose bit), again one
//     group: each separate wait costs a wgmma round trip that a block
//     cannot hide behind its own work.
//     Beyond BATCH_CHUNKS (N > 192) S and dp do not fit the registers
//     together, and dp runs chunk by chunk, twice (rd, then ds and dq). The
//     row max, the row sum and rd go to a small (G, nH, 3N) f32 scratch; in
//     mode (a) the keep bits drawn on the fragments go there as one 32-bit
//     word per row and 32 keys;
//   - pass 2, `attention_bwd_dkv_kernel`, tiles the keys (64 a block): one
//     key tile's k and v and every query's q and dctx in shared memory, the
//     statistics (and keep words) staged beside them; per 32-query chunk it
//     recomputes S^T = K Q^T and dp^T = V dO^T in one commit group, rebuilds
//     p^T from the statistics (no reduction over queries), and forms ds^T,
//     then dv += pa^T dO and dk += ds^T Q with the fragments as A operands.
//     Its registers do not grow with N. It also writes this head's column
//     sums of ds (the key-bias gradient) to a (G, nH, N) f32 scratch, and in
//     pattern mode walks a run of groups of one pattern, keeping their sum
//     of ds in shared memory (each element owned by one thread, summed in
//     group order) for a (chunks, P, nH, N, N) f32 scratch;
//   - two small kernels sum those scratches over heads and over chunks in a
//     fixed order.
// Shared memory is O(N Dh), never N x N: N <= 288 (nine 32-wide chunks, K2's
// bound) at head dims 16, 32, 48 and 64 (16 / 48 zero-padded to 32 / 64
// columns).
//
// The long form (N > 288, the sequence modes only: key bias, qbias, amask,
// regenerated dropout; not the pattern or stored-p modes): the counterpart
// of K2's long form, for the fused encoder at S = 298, 348 and 474, where
// JAX's `_seq_core_bwd_kernel` runs too (no length gate). Neither pass holds
// a whole row or column in registers or shared memory, so neither grows
// with N. Both passes take K2's long-form block (attention.cu): two
// consumer warpgroups of 64 rows share every chunk of a ring of LONG_STAGES
// stages that a producer warpgroup keeps full (TMA for the bf16 rows, 8- or
// 4-byte cp.async for the bias tiles, `full` / `empty` mbarriers,
// `setmaxnreg`), each step's products are issued one step ahead of the
// scalar work that reads them, and that work is branch-free per score:
//   - pass 1, `attention_bwd_dq_long_kernel`, owns 128 query rows (q's and
//     dctx's rows, loaded once) and streams the keys in 32-key chunks (k, v,
//     the key bias, the qbias and amask tiles) in two sweeps. (1) S and dp,
//     each row's max and its sum of exponentials l as K2 keeps them, and
//     beside them r = sum of e * dp * mask, rescaled by the same factor as
//     l whenever the max grows; at the row's end rd = r / l with the exact
//     divide. (2) S and dp again, p = e / l (exact divide), ds = p * dp *
//     mask - p * rd and dq += ds K. In the regenerated-dropout mode the
//     producer thread of each row draws its keep word of the chunk in the
//     first sweep, stages it and writes it to the scratch's words, and reads
//     it back from there in the second. Folding rd into the first sweep
//     (rather than summing the normalised p * dp * mask in a sweep of its
//     own) moves only the order of that f32 sum: p, pa and ds are rounded
//     to bf16 where they are in the register form and JAX's fast path. It
//     writes the statistics as the register form does;
//   - pass 2, `attention_bwd_dkv_long_kernel`, owns 128 keys (k's and v's
//     rows, loaded once) and streams the queries in 32-query chunks: their q
//     and dctx rows, their statistics (with RN(1 / row sum), taken once a
//     query by the producer) and keep words, and their qbias and amask rows
//     over the block's keys, which it reads down a column from shared
//     memory (the rows are padded so that the fragment's reads, keys along
//     the lanes, hit each bank once). The body per chunk is the register
//     form's pass 2.
// The dkbias column sums run in one fixed order (the queries in order,
// then the row quad, then `sum_heads_kernel` over heads), with no atomics.
// N is capped at 46,340 (i * N + j in 32 bits), as in K2. The long form
// also takes N <= 288 when a caller asks for it by form (the card's checks
// time the forms against each other).
//
// The middle form (160 < N <= 288, the sequence modes), K2's middle form's
// counterpart: the fusion encoder's 180 / 201 / 221 / 278. There the
// register form's pass 1 spills (past six chunks S and dp no longer fit its
// registers together and dp runs twice), keeps two blocks an SM and copies
// every key of k and v by cp.async before its first product; the long
// form's pass 1 computes S and the exponentials twice, and at odd N copies
// an amask's rows 2 bytes at a time. The design:
//   - pass 1, `attention_bwd_dq_mid_kernel<NC, DP>`: K2's middle-form block
//     (a producer and two consumer warpgroups on 128 query rows, 232
//     registers a consumer thread), q's and dctx's 128 rows and all of k and
//     v in shared memory by TMA, each key chunk on a barrier of its own, the
//     bias tiles through a five-stage ring staged as K2's middle form stages
//     them (an amask at odd N 16 bytes at a time, `stage_rows16`), the
//     block's qbias and amask rows asked into L2 at the start. S is computed
//     once and held for the whole row (144 f32 registers at N = 288), the
//     softmax runs on it in place as in the register form's pass 1, then dp
//     = dO V_c^T chunk by chunk for rd, then again for ds and dq += ds K_c,
//     the next chunk's product in flight under this chunk's scalar work (at
//     8-9 chunks of head dim 64 the next dp of the ds pass is issued only
//     after this chunk's dq product: two dp chunks and S do not fit the
//     registers). It writes the statistics and keep words as the other
//     forms do;
//   - pass 2 is the long form's; with an amask at odd N its ROWS16 variant
//     (`attention_bwd_dkv_long_kernel<DP, true>`: the amask rows staged 16
//     bytes at a time, each row's shift beside them).
// Every sum and rounding point is the register form's, rd included.
// The plan (`smem_bytes`, `scratch_words` below) is mirrored by
// `kernels.attention_bwd_plan` in ops/kernels.py, which admits a call
// before any launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "philox.cuh"

namespace {

using namespace mvlt;
using bf16 = __nv_bfloat16;

constexpr int THREADS = WARPGROUP;
constexpr int ROWS = 64;                  // a tile: one wgmma's M (queries in pass 1, keys in pass 2)
constexpr int KEYS = 32;                  // a chunk: one m64n32 product's N
constexpr int MAX_CHUNKS = 9;             // pass 1 keeps S in 9 x 16 f32 registers a thread
constexpr int MAX_N = MAX_CHUNKS * KEYS;  // 288
constexpr int BATCH_CHUNKS = 6;           // pass 1 holds S and dp of every chunk up to this count
// blocks the pattern mode aims to put on the card
constexpr int TARGET_BLOCKS = 1024;

__host__ __device__ constexpr int head_cols(int Dh) { return Dh <= 32 ? 32 : 64; }
__host__ __device__ constexpr int chunks_of(int N) { return (N + KEYS - 1) / KEYS; }
__host__ __device__ constexpr bool takes(int N, int Dh) {
  return N >= 1 && N <= MAX_N && Dh >= 16 && Dh <= 64 && Dh % 16 == 0;
}
// register caps: pass 1 holds S and dp (16 f32 each a chunk; beyond
// BATCH_CHUNKS dp of two chunks), dq and ds's fragments; pass 2 a chunk's
// S^T and dp^T, dk and dv (3 blocks an SM: more blocks to hide the latency
// of each chunk's chain beat a looser cap)
__host__ __device__ constexpr int dq_min_blocks(int nc) { return nc <= 1 ? 4 : nc <= 2 ? 3 : 2; }
constexpr int DKV_MIN_BLOCKS = 3;

// pass 1: q's and dctx's 64 rows, k and v over whole chunks, 1024 bytes of
// slack for the swizzle's alignment
__host__ __device__ constexpr int dq_smem(int N, int Dh) {
  return (2 * ROWS + 2 * chunks_of(N) * KEYS) * head_cols(Dh) * 2 + 1024;
}
// shared memory an H100 SM gives its blocks (228 KB), and what it keeps of it
// for each block
constexpr int SM_SMEM = 233472, BLOCK_RESERVED = 1024;
// pass 1 stages an amask's 64 rows of N bf16 (one contiguous span, and the
// 16 bytes by which its first 16-byte chunk may start before it) where that
// keeps dq_min_blocks blocks on an SM, as K2 does; else it reads them from
// device memory score by score
__host__ __device__ constexpr int dq_mask_smem(int N, int Dh) {
  return dq_smem(N, Dh) + ROWS * N * 2 + 16 <= SM_SMEM / dq_min_blocks(chunks_of(N)) - BLOCK_RESERVED
             ? ROWS * N * 2 + 16
             : 0;
}
// pass 2: a key tile's k and v, q and dctx over whole chunks (the same rows
// as pass 1), the statistics (row max, row sum, its reciprocal, rd) and two
// keep words per query
__host__ __device__ constexpr int dkv_smem(int N, int Dh) { return dq_smem(N, Dh) + 6 * chunks_of(N) * KEYS * 4; }
// pattern mode: the sum of ds over a run of groups, 64 keys x the queries in f32
__host__ __device__ constexpr int pattern_smem(int N) { return ROWS * chunks_of(N) * KEYS * 4; }
// the long form: rows a block (two consumer warpgroups; queries in pass 1,
// keys in pass 2), rows a ring chunk (keys in pass 1, queries in pass 2),
// ring stages, pass 1's sweeps over the keys, the largest N (i * N + j in 32
// bits), the block and the registers `setmaxnreg` gives each (128 x 56 + 256
// x 224 = 384 x 168)
constexpr int LONG_ROWS = 128, LONG_CHUNK = 32, LONG_STAGES = 4, LONG_SWEEPS = 2;
constexpr int LONG_MAX_N = 46340;
constexpr int LONG_THREADS = 3 * WARPGROUP, PRODUCER_REGS = 56, CONSUMER_REGS = 224;
// the long form past N = 288, and at any N a caller asks it for by form
__host__ __device__ constexpr bool long_takes(int N, int Dh) {
  return N >= 1 && N <= LONG_MAX_N && Dh >= 16 && Dh <= 64 && Dh % 16 == 0;
}
// pass 1's bias tiles of a stage, as K2's long form stages them: qbias 128
// query rows of 32 keys f32 (rows padded to 160 bytes), amask bf16 (80), the
// key bias's 32 f32
constexpr int QB_LD = 160, AM_LD = 80;
constexpr int QB_TILE = LONG_ROWS * QB_LD, AM_TILE = LONG_ROWS * AM_LD, KB_TILE = LONG_CHUNK * 4;
// regenerated dropout: each query row's keep word of the chunk (bit j keeps key key0 + j)
constexpr int KW_TILE = LONG_ROWS * 4;
// pass 2's: 32 query rows of the block's 128 keys, qbias f32 (rows padded to
// 528 bytes) and amask bf16 (264), read down a column; the queries' row max,
// row sum, rd and the row sum's correctly rounded reciprocal (four rows of 32
// f32), and their four keep words of the block's keys
constexpr int QB2_LD = 528, AM2_LD = 264;
constexpr int QB2_TILE = LONG_CHUNK * QB2_LD, AM2_TILE = LONG_CHUNK * AM2_LD;
constexpr int ST2_TILE = 4 * LONG_CHUNK * 4, BT2_TILE = LONG_CHUNK * 16;
// the middle form's pass 2 at odd N with an amask (the long form's with
// ROWS16): its amask rows padded to 272 bytes (a row of 128 bf16 staged
// from the 16-byte boundary at or before its start spans up to 17 chunks),
// each row's shift (32 bytes)
constexpr int AM2_LD16 = 272, AM2_CHUNKS = 17, SH2_TILE = LONG_CHUNK;
// 1024 bytes of slack for the swizzle's alignment, the block's two 128-row
// operands (q and dctx; k and v), the ring's two chunks a stage and its bias
// tiles (and pass 1's keep words), 128 bytes of mbarriers
__host__ __device__ constexpr int long_dq_smem(int Dh) {
  return 1024 + (2 * LONG_ROWS + LONG_STAGES * 2 * LONG_CHUNK) * head_cols(Dh) * 2 +
         LONG_STAGES * (QB_TILE + AM_TILE + KB_TILE + KW_TILE) + 128;
}
__host__ __device__ constexpr int long_dkv_smem(int Dh) {
  return 1024 + (2 * LONG_ROWS + LONG_STAGES * 2 * LONG_CHUNK) * head_cols(Dh) * 2 +
         LONG_STAGES * (QB2_TILE + AM2_TILE + ST2_TILE + BT2_TILE) + 128;
}
// the middle form's pass 2: the long form's with the wider amask rows and the rows' shifts
__host__ __device__ constexpr int mid_dkv_smem(int Dh) {
  return long_dkv_smem(Dh) + LONG_STAGES * (LONG_CHUNK * (AM2_LD16 - AM2_LD) + SH2_TILE);
}
// the forms of a launch (`form` of `mvlt_attention_bwd`, as K2's)
constexpr int FORM_REGISTER = 0, FORM_MIDDLE = 1, FORM_LONG = 2;
// the middle form's first pass: 6-9 key chunks (161 <= N <= 288), the
// ring's stages of bias tiles, the registers `setmaxnreg` gives the
// producer and each consumer (128 x 40 + 256 x 232 = 384 x 168)
constexpr int MID_MIN_CHUNKS = 6, MID_MIN_N = (MID_MIN_CHUNKS - 1) * KEYS + 1, MID_STAGES = 5;
constexpr int MID_PRODUCER_REGS = 40, MID_CONSUMER_REGS = 232;
// a stage of the middle form's ring holds the bias pass's qbias tile and
// key bias (QB_TILE + KB_TILE bytes) or, later, the P V pass's amask tile
// in the same bytes (AM_TILE < QB_TILE)
constexpr int MID_STAGE = QB_TILE + KB_TILE;
// the 16-byte chunks a staged row of 32 amask bf16 may span (`stage_rows16`,
// from the boundary at or before its start: AM_LD bytes hold them)
constexpr int AM_CHUNKS = 5;
__host__ __device__ constexpr bool mid_takes(int N, int Dh) {
  return N >= MID_MIN_N && N <= MAX_N && Dh >= 16 && Dh <= 64 && Dh % 16 == 0;
}
// its first pass: 1024 bytes of slack, q's and dctx's 128 rows, k and v
// over whole chunks, the ring's stages, the keep words of every chunk, 256
// bytes of mbarriers; its second pass is the long form's
__host__ __device__ constexpr int mid_dq_smem(int N, int Dh) {
  return 1024 + (2 * LONG_ROWS + 2 * chunks_of(N) * KEYS) * head_cols(Dh) * 2 + MID_STAGES * MID_STAGE +
         chunks_of(N) * KW_TILE + 256;
}
__host__ __device__ constexpr int larger(int a, int b) { return a > b ? a : b; }
// shared memory of the larger pass of the given form, or -1 where that form
// does not take (N, Dh) (the middle and long forms have no pattern mode)
__host__ __device__ constexpr long long smem_bytes(int N, int Dh, bool pattern, bool amask, int form) {
  return form == FORM_LONG     ? (long_takes(N, Dh) && !pattern ? larger(long_dq_smem(Dh), long_dkv_smem(Dh)) : -1)
         : form == FORM_MIDDLE ? (mid_takes(N, Dh) && !pattern ? larger(mid_dq_smem(N, Dh), mid_dkv_smem(Dh)) : -1)
         : form != FORM_REGISTER || !takes(N, Dh)
             ? -1
             : larger(dq_smem(N, Dh) + (amask ? dq_mask_smem(N, Dh) : 0),
                      dkv_smem(N, Dh) + (pattern ? pattern_smem(N) : 0));
}
// f32 scratch words per (g, h): row max, row sum and rd of every query, then
// the keep bits, one word per query and 32 keys
__host__ __device__ constexpr long long scratch_words(int N) { return 3LL * N + (long long)N * chunks_of(N); }

struct Params {
  const bf16* qkv;
  const bf16* dctx;
  const float* pattern;
  const float* kbias;
  const float* qbias;
  const bf16* amask;
  const int* seed;
  const bf16* pstore;
  bf16* dqkv;
  float* dkb_part;
  float* dpat_part;
  float* scratch;
  long long words;  // scratch words per (g, h)
  int N, C, nH, Dh, P;
  int tiles;              // 64-row tiles of N: query tiles in pass 1, key tiles in pass 2
  int mask_staged;        // pass 1 stages the amask rows (dq_mask_smem > 0)
  int stride, per, wpb;   // pass 2: groups pat + jw * stride, jw in the block's run of wpb (of per)
  int qb_unit, am_unit, kb_unit;  // the long form's bias-tile copies (`stage_unit`)
  float scale;
  uint32_t thresh;
  float kept;
  int head0;  // mode (a): the global index of head 0 (a tensor-parallel rank's heads)
};

// dq of one 64-query tile of (g, h); the statistics and keep words for pass 2
template <int NC, int DP>
__global__ void __launch_bounds__(THREADS, dq_min_blocks(NC)) attention_bwd_dq_kernel(const Params p) {
  constexpr int ROWB = DP * 2;
  constexpr int KR = NC * KEYS;
  constexpr uint64_t SW = DP == 64 ? SWIZZLE_128B : SWIZZLE_64B;
  constexpr uint32_t SBO = 8 * ROWB;  // 8-row groups of every operand
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Ds = Qs + ROWS * ROWB;  // dctx rows of the tile
  unsigned char* Ks = Ds + ROWS * ROWB;
  unsigned char* Vs = Ks + KR * ROWB;
  unsigned char* Ms = Vs + KR * ROWB;  // the amask rows, when staged

  const int N = p.N, C = p.C, Dh = p.Dh;
  const int tile = blockIdx.x % p.tiles;
  const int gh = blockIdx.x / p.tiles;
  const int h = gh % p.nH, g = gh / p.nH;
  const int row0 = tile * ROWS;
  const long long ld = 3LL * C;
  const long long in0 = (long long)g * N * ld;
  const bf16* qs = p.qkv + h * Dh;
  const size_t nn = (size_t)N * N;
  const size_t t0 = (size_t)gh * nn;  // (g, h)'s N x N block of amask and pstore
  float* st = p.scratch + gh * p.words;

  if (!p.pstore) load_rows<ROWB>(Qs, qs, in0, ld, row0, ROWS, N, Dh);
  load_rows<ROWB>(Ks, qs + C, in0, ld, 0, KR, N, Dh);
  cp_async_commit();
  load_rows<ROWB>(Ds, p.dctx + h * Dh, (long long)g * N * C, C, row0, ROWS, N, Dh);
  load_rows<ROWB>(Vs, qs + 2 * C, in0, ld, 0, KR, N, Dh);
  // byte b of (g, h)'s amask block sits at Ms + b - m_off
  long long m_off = 0;
  if (p.mask_staged)
    m_off = (long long)stage_span(Ms, reinterpret_cast<uintptr_t>(p.amask + t0 + (size_t)row0 * N),
                                  reinterpret_cast<uintptr_t>(p.amask + t0 + (size_t)min(row0 + ROWS, N) * N)) -
            (long long)reinterpret_cast<uintptr_t>(p.amask + t0);
  cp_async_commit();

  // element x of chunk c sits in row r0 + 8 hh, column cq + col(c, x), as in K2
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const bool live_warp = row0 + warp * 16 < N;
  const bool live0 = row0 + r0 < N, live1 = row0 + r0 + 8 < N;
  const int erow0 = (row0 + r0) * N, erow1 = (row0 + r0 + 8) * N;
  auto col = [](int c, int x) { return c * KEYS + (x >> 2) * 8 + (x & 1); };

  // (a): bit x of keep[c] keeps element x of chunk c, drawn while the copies
  // are in flight; pass 2 reads them back as one word per row and chunk
  uint32_t keep[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) keep[c] = 0;
  if (p.seed && live_warp) {
    const uint32_t key = adrop_key(p.seed), ctr1 = (uint32_t)g * 256u + (uint32_t)(h + p.head0);
    uint32_t* bits = reinterpret_cast<uint32_t*>(st + 3 * N);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      keep[c] = draw_chunk(c * KEYS, erow0, erow1, live0, live1, cq, lane, N, key, ctr1, p.thresh, p.kept, nullptr);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t w = 0;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
#pragma unroll
          for (int k = 0; k < 2; ++k) w |= ((keep[c] >> (4 * bb + 2 * hh + k)) & 1u) << (8 * bb + cq + k);
        w |= __shfl_xor_sync(0xffffffffu, w, 1);
        w |= __shfl_xor_sync(0xffffffffu, w, 2);
        if ((lane & 3) == 0 && (hh ? live1 : live0)) bits[(row0 + r0 + 8 * hh) * NC + c] = w;
      }
    }
  }
  cp_async_wait<1>();  // q and k are in
  fence_proxy_async();
  __syncthreads();

  const uint32_t q_base = smem_u32(Qs), d_base = smem_u32(Ds), k_base = smem_u32(Ks), v_base = smem_u32(Vs);
  float s[NC][16];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int x = 0; x < 16; ++x) s[c][x] = 0.f;
    fence_acc(s[c]);
  }
  if (!p.pstore) {  // S = Q K^T (block-uniform: every warp issues it)
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_m64n32k16(s[c], make_desc(q_base + kk * 32, 16, SBO, SW),
                        make_desc(k_base + c * KEYS * ROWB + kk * 32, 16, SBO, SW));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_acc(s[c]);
  }

  if (live_warp && p.pstore) {  // (b): p as stored
    const bf16* ps = p.pstore + t0;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int hh = (x >> 1) & 1, j = cq + col(c, x);
        s[c][x] = (hh ? live1 : live0) && j < N ? __bfloat162float(__ldg(ps + (hh ? erow1 : erow0) + j)) : 0.f;
      }
  } else if (live_warp) {  // the softmax on the fragments, as K2 computes it
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
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
    // the exact divide v / sum as Markstein's correction of v * RN(1 / sum)
    const float rcp[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int hh = (x >> 1) & 1;
        const float q0 = s[c][x] * rcp[hh];
        s[c][x] = fmaf(fmaf(-q0, sum[hh], s[c][x]), rcp[hh], q0);
      }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (hh ? live1 : live0) {
          const int i = row0 + r0 + 8 * hh;
          st[i] = mx[hh];
          st[N + i] = sum[hh];
        }
    }
  }
  cp_async_wait<0>();  // dctx and v are in
  fence_proxy_async();
  __syncthreads();

  // the dropout multiplier of element x of chunk c (0 outside the block)
  const bf16* am = p.amask ? p.amask + t0 : nullptr;
  auto mask_of = [&](int c, int x) -> float {
    const int hh = (x >> 1) & 1, j = cq + col(c, x);
    if (!(hh ? live1 : live0) || j >= N) return 0.f;
    const int e = (hh ? erow1 : erow0) + j;
    if (am)
      return __bfloat162float(p.mask_staged ? *reinterpret_cast<const bf16*>(Ms + 2LL * e - m_off) : __ldg(am + e));
    if (p.seed) return (keep[c] >> x) & 1u ? p.kept : 0.f;
    return 1.f;
  };
  float rd[2] = {0.f, 0.f};
  float dq[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) dq[x] = 0.f;
  fence_acc(dq);
  if constexpr (NC <= BATCH_CHUNKS) {
    // dp = dO V^T over every chunk in one commit group, beside S in registers
    float dp[NC][16];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int x = 0; x < 16; ++x) dp[c][x] = 0.f;
      fence_acc(dp[c]);
    }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_m64n32k16(dp[c], make_desc(d_base + kk * 32, 16, SBO, SW),
                        make_desc(v_base + c * KEYS * ROWB + kk * 32, 16, SBO, SW));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_acc(dp[c]);
    // rd = rowsum(p * dp * mask), then ds = p * dp * mask - p * rd in place of p
    if (live_warp) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          dp[c][x] *= mask_of(c, x);
          rd[(x >> 1) & 1] += s[c][x] * dp[c][x];
        }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rd[hh] += __shfl_xor_sync(0xffffffffu, rd[hh], 1);
      rd[hh] += __shfl_xor_sync(0xffffffffu, rd[hh], 2);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const float pv = s[c][x];
        s[c][x] = live_warp ? pv * dp[c][x] - pv * rd[(x >> 1) & 1] : 0.f;
      }
    // dq = ds K: every chunk's ds in bf16 pairs as the A operand, one group
    uint32_t a[NC][2][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16)
#pragma unroll
        for (int q = 0; q < 4; ++q) a[c][k16][q] = pack_bf16(s[c][8 * k16 + 2 * q], s[c][8 * k16 + 2 * q + 1]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16) {
        // 16 key rows of k; one column block, so LBO is unused (given SBO's value)
        const uint64_t bk = make_desc(k_base + (c * KEYS + k16 * 16) * ROWB, SBO, SBO, SW);
        if constexpr (DP == 64)
          wgmma_m64n64k16_rs(dq, a[c][k16], bk);
        else
          wgmma_m64n32k16_rs(dq, a[c][k16], bk);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dq);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16) fence_regs(a[c][k16]);
  } else {
    // S and every chunk's dp do not fit the registers together: dp chunk
    // by chunk (the next chunk's product in flight while one is read),
    // once for rd and once for ds and dq
    float dp[2][16];
    auto issue_dp = [&](int c, float(&acc)[16]) {
#pragma unroll
      for (int x = 0; x < 16; ++x) acc[x] = 0.f;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_m64n32k16(acc, make_desc(d_base + kk * 32, 16, SBO, SW),
                        make_desc(v_base + c * KEYS * ROWB + kk * 32, 16, SBO, SW));
      wgmma_commit();
    };
    issue_dp(0, dp[0]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c + 1 < NC) {
        issue_dp(c + 1, dp[(c + 1) & 1]);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_acc(dp[c & 1]);
      if (live_warp) {
#pragma unroll
        for (int x = 0; x < 16; ++x) rd[(x >> 1) & 1] += s[c][x] * (dp[c & 1][x] * mask_of(c, x));
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rd[hh] += __shfl_xor_sync(0xffffffffu, rd[hh], 1);
      rd[hh] += __shfl_xor_sync(0xffffffffu, rd[hh], 2);
    }
    uint32_t a[2][4];
    issue_dp(0, dp[0]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c + 1 < NC) {
        issue_dp(c + 1, dp[(c + 1) & 1]);
        wgmma_wait<1>();  // dp of chunk c and the previous dq product are done
      } else {
        wgmma_wait<0>();
      }
      fence_acc(dp[c & 1]);
      fence_acc(dq);
      fence_regs(a[0]);
      fence_regs(a[1]);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float d2[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int x = 2 * q + k;
          const float pv = s[c][x];
          const float pdp = pv * (dp[c & 1][x] * mask_of(c, x));
          d2[k] = live_warp ? pdp - pv * rd[(x >> 1) & 1] : 0.f;
        }
        a[q >> 2][q & 3] = pack_bf16(d2[0], d2[1]);
      }
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16) {
        const uint64_t bk = make_desc(k_base + (c * KEYS + k16 * 16) * ROWB, SBO, SBO, SW);
        if constexpr (DP == 64)
          wgmma_m64n64k16_rs(dq, a[k16], bk);
        else
          wgmma_m64n32k16_rs(dq, a[k16], bk);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(dq);
    fence_regs(a[0]);
    fence_regs(a[1]);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (hh ? live1 : live0) st[2 * N + row0 + r0 + 8 * hh] = rd[hh];
  }

  // dq * scale: bf16 pairs into q's rows (no product reads them any more),
  // then 16-byte stores of the rows below N
#pragma unroll
  for (int b = 0; b < DP / 8; ++b) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(Qs + swz<ROWB>(r0 + 8 * hh, b) + cq * 2) =
          pack_bf16(dq[4 * b + 2 * hh] * p.scale, dq[4 * b + 2 * hh + 1] * p.scale);
  }
  __syncthreads();
  const int chunks = Dh / 8;
  for (int e = threadIdx.x; e < ROWS * chunks; e += THREADS) {
    const int r = e / chunks, c = e % chunks;
    const int i = row0 + r;
    if (i < N)
      *reinterpret_cast<uint4*>(p.dqkv + in0 + i * ld + h * Dh + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<ROWB>(r, c));
  }
}

// dk and dv of one 64-key tile of (g, h) for each group of the block's run;
// the head's column sums of ds and, in pattern mode, their sum over the run
template <int DP>
__global__ void __launch_bounds__(THREADS, DKV_MIN_BLOCKS) attention_bwd_dkv_kernel(const Params p) {
  constexpr int ROWB = DP * 2;
  constexpr uint64_t SW = DP == 64 ? SWIZZLE_128B : SWIZZLE_64B;
  constexpr uint32_t SBO = 8 * ROWB;
  const int N = p.N, C = p.C, Dh = p.Dh;
  const int nc = chunks_of(N), KR = nc * KEYS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);  // the key tile's k, then dk
  unsigned char* Vs = Ks + ROWS * ROWB;     // its v, then dv
  unsigned char* Qs = Vs + ROWS * ROWB;     // q of every query
  unsigned char* Ds = Qs + KR * ROWB;       // dctx of every query
  float* Sm = reinterpret_cast<float*>(Ds + KR * ROWB);  // row max
  float* Sl = Sm + KR;                                   // row sum
  float* Sr = Sl + KR;                                   // RN(1 / row sum)
  float* Sd = Sr + KR;                                   // rd
  uint32_t* Bt = reinterpret_cast<uint32_t*>(Sd + KR);   // (a): the tile's two keep words per query
  float* Acc = reinterpret_cast<float*>(Bt + 2 * KR);    // pattern mode: the run's sum of ds

  int b = blockIdx.x;
  const int kt = b % p.tiles;
  b /= p.tiles;
  const int h = b % p.nH;
  b /= p.nH;
  const int pat = b % p.stride, run = b / p.stride;
  const int key0 = kt * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const bool live_warp = key0 + warp * 16 < N;
  const int jr[2] = {key0 + r0, key0 + r0 + 8};  // the thread's two key rows
  const bool kl[2] = {jr[0] < N, jr[1] < N};
  const bool pattern_mode = p.dpat_part != nullptr;
  if (pattern_mode)  // each thread owns its elements: no barrier
    for (int e = 0; e < nc * 16; ++e) Acc[e * THREADS + threadIdx.x] = 0.f;
  const long long ld = 3LL * C;
  const size_t nn = (size_t)N * N;
  const bf16* qs = p.qkv + h * Dh;
  const uint32_t k_base = smem_u32(Ks), v_base = smem_u32(Vs), q_base = smem_u32(Qs), d_base = smem_u32(Ds);

  const int jw1 = min(p.per, (run + 1) * p.wpb);
  for (int jw = run * p.wpb; jw < jw1; ++jw) {
    const int g = pat + jw * p.stride;  // groups of one pattern, in order
    const int gh = g * p.nH + h;
    const long long in0 = (long long)g * N * ld;
    __syncthreads();  // the previous group's tiles are no longer read
    load_rows<ROWB>(Ks, qs + C, in0, ld, key0, ROWS, N, Dh);
    load_rows<ROWB>(Vs, qs + 2 * C, in0, ld, key0, ROWS, N, Dh);
    load_rows<ROWB>(Qs, qs, in0, ld, 0, KR, N, Dh);
    load_rows<ROWB>(Ds, p.dctx + h * Dh, (long long)g * N * C, C, 0, KR, N, Dh);
    cp_async_commit();
    const float* st = p.scratch + gh * p.words;
    const uint32_t* bits = reinterpret_cast<const uint32_t*>(st + 3 * N);
    for (int i = threadIdx.x; i < KR; i += THREADS) {
      const bool in = i < N, stats = in && !p.pstore;
      const float l = stats ? st[N + i] : 1.f;
      Sm[i] = stats ? st[i] : 0.f;
      Sl[i] = l;
      Sr[i] = __frcp_rn(l);
      Sd[i] = in ? st[2 * N + i] : 0.f;
      if (p.seed) {
        Bt[2 * i] = in ? bits[i * nc + 2 * kt] : 0u;
        Bt[2 * i + 1] = in && 2 * kt + 1 < nc ? bits[i * nc + 2 * kt + 1] : 0u;
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();

    const size_t t0 = (size_t)gh * nn;
    const float* pb = p.pattern ? p.pattern + ((size_t)(g % p.P) * p.nH + h) * nn : nullptr;
    const float* qb = p.qbias ? p.qbias + (size_t)g * nn : nullptr;
    const bf16* am = p.amask ? p.amask + t0 : nullptr;
    const bf16* ps = p.pstore ? p.pstore + t0 : nullptr;
    float kbv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) kbv[hh] = p.kbias && kl[hh] ? __ldg(p.kbias + (size_t)g * N + jr[hh]) : 0.f;

    float dk[DP / 2], dv[DP / 2], dkb[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) dk[x] = dv[x] = 0.f;
    fence_acc(dk);
    fence_acc(dv);
    uint32_t apa[2][4], ads[2][4];
    float s[16], dp[16];
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      // S^T = K Q_c^T (unless p is stored) and dp^T = V dO_c^T, one group;
      // it also retires the previous chunk's dk / dv products
#pragma unroll
      for (int x = 0; x < 16; ++x) s[x] = dp[x] = 0.f;
      fence_acc(s);
      fence_acc(dp);
      wgmma_fence();
      if (!ps) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_m64n32k16(s, make_desc(k_base + kk * 32, 16, SBO, SW),
                          make_desc(q_base + c * KEYS * ROWB + kk * 32, 16, SBO, SW));
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_m64n32k16(dp, make_desc(v_base + kk * 32, 16, SBO, SW),
                        make_desc(d_base + c * KEYS * ROWB + kk * 32, 16, SBO, SW));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      fence_acc(dk);
      fence_acc(dv);
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16) {
        fence_regs(apa[k16]);
        fence_regs(ads[k16]);
      }
      // element x: key row jr[hh], query column i
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float pa2[2], ds2[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int x = 2 * q + k, hh = (x >> 1) & 1;
          const int i = c * KEYS + (x >> 2) * 8 + cq + (x & 1);
          const int j = jr[hh];
          float pv = 0.f, m = 0.f;
          if (live_warp && kl[hh] && i < N) {
            const int e = i * N + j;
            if (ps) {
              pv = __bfloat162float(__ldg(ps + e));
            } else {
              float v = s[x] * p.scale;
              if (pb) v += __ldg(pb + e);
              if (p.kbias) v += kbv[hh];
              if (qb) v += __ldg(qb + e);
              const float ex = expf(v - Sm[i]);
              const float q0 = ex * Sr[i];
              pv = fmaf(fmaf(-q0, Sl[i], ex), Sr[i], q0);
            }
            const int jl = j - key0;
            m = am ? __bfloat162float(__ldg(am + e))
                   : p.seed ? ((Bt[2 * i + (jl >> 5)] >> (jl & 31)) & 1u ? p.kept : 0.f) : 1.f;
          }
          const float pdp = pv * (dp[x] * m);
          ds2[k] = pdp - pv * Sd[i];
          pa2[k] = pv * m;
          dkb[hh] += ds2[k];
          if (pattern_mode) Acc[(c * 16 + x) * THREADS + threadIdx.x] += ds2[k];
        }
        apa[q >> 2][q & 3] = pack_bf16(pa2[0], pa2[1]);
        ads[q >> 2][q & 3] = pack_bf16(ds2[0], ds2[1]);
      }
      // dv += pa^T dO_c, dk += ds^T Q_c: 16 query rows a k16 step, read
      // MN-major (their head columns contiguous)
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16) {
        const uint32_t row = (c * KEYS + k16 * 16) * ROWB;
        const uint64_t bd = make_desc(d_base + row, SBO, SBO, SW), bq = make_desc(q_base + row, SBO, SBO, SW);
        if constexpr (DP == 64) {
          wgmma_m64n64k16_rs(dv, apa[k16], bd);
          wgmma_m64n64k16_rs(dk, ads[k16], bq);
        } else {
          wgmma_m64n32k16_rs(dv, apa[k16], bd);
          wgmma_m64n32k16_rs(dk, ads[k16], bq);
        }
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(dk);
    fence_acc(dv);
#pragma unroll
    for (int k16 = 0; k16 < 2; ++k16) {
      fence_regs(apa[k16]);
      fence_regs(ads[k16]);
    }

    // this head's column sums of ds, one value per key over the row quad
    if (p.dkb_part) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        dkb[hh] += __shfl_xor_sync(0xffffffffu, dkb[hh], 1);
        dkb[hh] += __shfl_xor_sync(0xffffffffu, dkb[hh], 2);
        if ((lane & 3) == 0 && kl[hh]) p.dkb_part[(size_t)gh * N + jr[hh]] = dkb[hh];
      }
    }

    // dk * scale and dv: bf16 pairs into k's and v's rows, then 16-byte
    // stores of the keys below N
    __syncthreads();  // every warp's products have read Ks / Vs
#pragma unroll
    for (int bb = 0; bb < DP / 8; ++bb) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t off = swz<ROWB>(r0 + 8 * hh, bb) + cq * 2;
        *reinterpret_cast<uint32_t*>(Ks + off) =
            pack_bf16(dk[4 * bb + 2 * hh] * p.scale, dk[4 * bb + 2 * hh + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(Vs + off) = pack_bf16(dv[4 * bb + 2 * hh], dv[4 * bb + 2 * hh + 1]);
      }
    }
    __syncthreads();
    const int chunks = Dh / 8;
    for (int e = threadIdx.x; e < ROWS * chunks; e += THREADS) {
      const int r = e / chunks, cc = e % chunks;
      const int j = key0 + r;
      if (j < N) {
        bf16* out = p.dqkv + in0 + j * ld + h * Dh + cc * 8;
        *reinterpret_cast<uint4*>(out + C) = *reinterpret_cast<const uint4*>(Ks + swz<ROWB>(r, cc));
        *reinterpret_cast<uint4*>(out + 2 * C) = *reinterpret_cast<const uint4*>(Vs + swz<ROWB>(r, cc));
      }
    }
  }

  if (pattern_mode) {  // the run's sum of ds into its slice of the scratch
    float* out = p.dpat_part + (((size_t)run * p.stride + pat) * p.nH + h) * nn;
    for (int c = 0; c < nc; ++c)
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int hh = (x >> 1) & 1;
        const int i = c * KEYS + (x >> 2) * 8 + cq + (x & 1);
        if (kl[hh] && i < N) out[(size_t)i * N + jr[hh]] = Acc[(c * 16 + x) * THREADS + threadIdx.x];
      }
  }
}

// The long form's pass 1 (N > 288): dq of 128 query rows of (g, h) on two
// consumer warpgroups, the statistics and keep words for pass 2; the keys
// streamed in 32-key chunks by the producer warpgroup, two sweeps (see the
// head of the file). Step `it` of the 2 * nch steps is chunk it % nch of
// sweep it / nch, in ring stage it % LONG_STAGES.
template <int DP>
__global__ void __launch_bounds__(LONG_THREADS, 1)
    attention_bwd_dq_long_kernel(const __grid_constant__ CUtensorMap map_qkv,
                                 const __grid_constant__ CUtensorMap map_do, const Params p) {
  constexpr int ROWB = DP * 2;
  constexpr uint64_t SW = DP == 64 ? SWIZZLE_128B : SWIZZLE_64B;
  constexpr uint32_t SBO = 8 * ROWB;
  constexpr int KV = LONG_CHUNK * ROWB;  // one chunk of k or of v
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Ds = Qs + LONG_ROWS * ROWB;    // dctx's rows
  unsigned char* Ring = Ds + LONG_ROWS * ROWB;  // stage s: k at Ring + 2 s KV, then v
  unsigned char* Qb = Ring + LONG_STAGES * 2 * KV;
  unsigned char* Am = Qb + LONG_STAGES * QB_TILE;
  unsigned char* Kb = Am + LONG_STAGES * AM_TILE;
  uint32_t* Kw = reinterpret_cast<uint32_t*>(Kb + LONG_STAGES * KB_TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(Kw + LONG_STAGES * LONG_ROWS);
  uint64_t* empty = full + LONG_STAGES;
  uint64_t* qbar = empty + LONG_STAGES;

  const int N = p.N, C = p.C, Dh = p.Dh, nH = p.nH;
  const int tile = blockIdx.x % p.tiles;
  const int gh = blockIdx.x / p.tiles;
  const int h = gh % nH, g = gh / nH;
  const int row0 = tile * LONG_ROWS;
  const int nch = chunks_of(N), steps = LONG_SWEEPS * nch;  // 32-key chunks: one keep word each
  float* stt = p.scratch + gh * p.words;
  uint32_t* bits = reinterpret_cast<uint32_t*>(stt + 3 * N);
  const int wg = threadIdx.x / WARPGROUP;
  if (threadIdx.x == 0) {
    for (int s = 0; s < LONG_STAGES; ++s) {
      mbar_init(&full[s], 1 + 2 * WARPGROUP);  // the TMA thread's expect_tx + two a producer thread
      mbar_init(&empty[s], 8);                  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    regs_dec<PRODUCER_REGS>();
    const int t = threadIdx.x;
    if (t == 0) {
      mbar_expect_tx(qbar, 2 * LONG_ROWS * ROWB);
      for (int r = 0; r < LONG_ROWS; r += LONG_CHUNK) {
        tma_load4(Qs + r * ROWB, &map_qkv, qbar, 0, h, row0 + r, g);
        tma_load4(Ds + r * ROWB, &map_do, qbar, 0, h, row0 + r, g);
      }
    }
    const unsigned char* kb0 = reinterpret_cast<const unsigned char*>(p.kbias + (size_t)g * N);
    const unsigned char* qb0 = reinterpret_cast<const unsigned char*>(p.qbias + ((size_t)g * N + row0) * N);
    const unsigned char* am0 = reinterpret_cast<const unsigned char*>(p.amask + ((size_t)gh * N + row0) * N);
    const int rlim = N - row0;
    const uint32_t key = p.seed ? adrop_key(p.seed) : 0u, ctr1 = (uint32_t)g * 256u + (uint32_t)(h + p.head0);
    for (int it = 0; it < steps; ++it) {
      const int s = it % LONG_STAGES;
      if (it >= LONG_STAGES) mbar_wait(&empty[s], ((it / LONG_STAGES) - 1) & 1);
      const int key0 = (it % nch) * LONG_CHUNK, clim = N - key0;
      unsigned char* kst = Ring + s * 2 * KV;
      if (t == 0) {
        mbar_expect_tx(&full[s], 2 * KV);
        tma_load4(kst, &map_qkv, &full[s], 0, nH + h, key0, g);
        tma_load4(kst + KV, &map_qkv, &full[s], 0, 2 * nH + h, key0, g);
      }
      if (p.kbias)
        stage_tile_any<4>(p.kb_unit, Kb + s * KB_TILE, 0, kb0 + key0 * 4, 0, 1, LONG_CHUNK, 1, clim, t, WARPGROUP);
      if (p.qbias)
        stage_tile_any<4>(p.qb_unit, Qb + s * QB_TILE, QB_LD, qb0 + key0 * 4, 4LL * N, LONG_ROWS, LONG_CHUNK, rlim,
                          clim, t, WARPGROUP);
      if (p.amask)
        stage_tile_any<2>(p.am_unit, Am + s * AM_TILE, AM_LD, am0 + key0 * 2, 2LL * N, LONG_ROWS,
                          LONG_CHUNK, rlim, clim, t, WARPGROUP);
      if (p.seed) {
        // row t's keep word of the chunk: drawn in the first sweep and written
        // to the scratch (one word per row and 32 keys, as the register form
        // writes them), read back from there in the second
        const int i = row0 + t, c = it % nch;
        uint32_t wd = 0u;
        if (i < N) {
          if (it < nch) {
            wd = keep_word(i, key0, N, key, ctr1, p.thresh);
            bits[i * nch + c] = wd;
          } else {
            wd = bits[i * nch + c];
          }
        }
        Kw[s * LONG_ROWS + t] = wd;
      }
      stage_arrive(&full[s]);
    }
    cp_async_wait<0>();
    return;
  }

  // the consumers: warpgroup w owns block rows 64 w .. 64 w + 63; element x
  // = 4 b + 2 hh + e of a chunk's fragment sits in block row r0 + 8 hh,
  // chunk column cq + 8 b + e
  regs_inc<CONSUMER_REGS>();
  const int w = wg - 1, tid = threadIdx.x - wg * WARPGROUP;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = w * 64 + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const bool live_warp = row0 + w * 64 + warp * 16 < N;
  const bool live0 = row0 + r0 < N, live1 = row0 + r0 + 8 < N;
  const uint32_t q_base = smem_u32(Qs + w * 64 * ROWB), d_base = smem_u32(Ds + w * 64 * ROWB);
  const uint32_t ring = smem_u32(Ring);

  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, r[2] = {0.f, 0.f};
  float rcp[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
  float dq[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) dq[x] = 0.f;
  fence_acc(dq);
  uint32_t a[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};  // ds in bf16: the A operand of dq += ds K
  float s[16], dp[16], ns[16], ndp[16];  // S and dp of this step; the next step's, in flight
  mbar_wait(qbar, 0);
  mbar_wait(&full[0], 0);
  wgmma_rows32_pair<DP>(ns, q_base, ring, ndp, d_base, ring + KV);

#pragma unroll 1
  for (int it = 0; it < steps; ++it) {
    const bool second = it >= nch;
    const int c = second ? it - nch : it, c0 = c * LONG_CHUNK;
    const int st = it % LONG_STAGES;
    // S and dp of step it are in (dq += ds K of step it - 1 may still run)
    if (it > nch)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    fence_acc(ns);
    fence_acc(ndp);
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      s[x] = ns[x];
      dp[x] = ndp[x];
    }
    const bool ahead = it + 1 < steps;
    if (ahead) {  // the next step's products run under this step's scalar work
      const uint32_t kn = ring + ((it + 1) % LONG_STAGES) * 2 * KV;
      mbar_wait(&full[(it + 1) % LONG_STAGES], ((it + 1) / LONG_STAGES) & 1);
      wgmma_rows32_pair<DP>(ns, q_base, kn, ndp, d_base, kn + KV);
    }
    if (it > nch) {  // dq += ds K of step it - 1 is done: its stage is free, a may be rewritten
      if (ahead)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence_acc(dq);
      fence_regs(a[0]);
      fence_regs(a[1]);
      release_stage(&empty[(it - 1) % LONG_STAGES], lane);
    }

    // scale and biases, and dp * mask, from the stage's tiles. Branch-free
    // per score: rows past N take whatever their tile rows hold (they feed
    // only rows that are never stored); keys past N, only in the last chunk
    // (a uniform branch), are -inf with a mask of 0
    const bool tail = c0 + LONG_CHUNK > N;
    if (live_warp) {
      const unsigned char* qbr = Qb + st * QB_TILE + r0 * QB_LD;
      const unsigned char* amr = Am + st * AM_TILE + r0 * AM_LD;
      const float* kbs = reinterpret_cast<const float*>(Kb + st * KB_TILE);
      float m[16];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int lc = cq + 8 * b;
        const float2 kb2 = p.kbias ? *reinterpret_cast<const float2*>(kbs + lc) : make_float2(0.f, 0.f);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * b + 2 * hh;
          const float2 qb2 =
              p.qbias ? *reinterpret_cast<const float2*>(qbr + hh * 8 * QB_LD + lc * 4) : make_float2(0.f, 0.f);
          // the register form's order: scale, key bias, then qbias (absent: + 0, exact)
          s[x] = s[x] * p.scale + kb2.x + qb2.x;
          s[x + 1] = s[x + 1] * p.scale + kb2.y + qb2.y;
          const float2 m2 =
              p.amask ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(amr + hh * 8 * AM_LD + lc * 2))
                      : make_float2(1.f, 1.f);
          m[x] = m2.x;
          m[x + 1] = m2.y;
        }
      }
      if (p.seed) {  // the rows' keep words, drawn by the producer
        const uint32_t kw[2] = {Kw[st * LONG_ROWS + r0], Kw[st * LONG_ROWS + r0 + 8]};
#pragma unroll
        for (int x = 0; x < 16; ++x) m[x] = (kw[(x >> 1) & 1] >> (cq + (x >> 2) * 8 + (x & 1))) & 1u ? p.kept : 0.f;
      }
      if (tail) {
#pragma unroll
        for (int x = 0; x < 16; ++x)
          if (c0 + cq + (x >> 2) * 8 + (x & 1) >= N) {
            s[x] = -INFINITY;
            m[x] = 0.f;
          }
      }
#pragma unroll
      for (int x = 0; x < 16; ++x) dp[x] *= m[x];
    }

    if (!second) {
      if (live_warp) {
        // the chunk's row max over the quad; l and r rescaled to the new max
        float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int x = 0; x < 16; ++x) cm[(x >> 1) & 1] = fmaxf(cm[(x >> 1) & 1], s[x]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          cm[hh] = fmaxf(cm[hh], __shfl_xor_sync(0xffffffffu, cm[hh], 1));
          cm[hh] = fmaxf(cm[hh], __shfl_xor_sync(0xffffffffu, cm[hh], 2));
          const float nm = fmaxf(mx[hh], cm[hh]);  // finite: every chunk holds a key below N
          const float f = expf(mx[hh] - nm);        // 1 where the max holds, 0 before the first chunk
          l[hh] *= f;
          r[hh] *= f;
          mx[hh] = nm;
        }
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          const int hh = (x >> 1) & 1;
          const float ex = expf(s[x] - mx[hh]);
          l[hh] += ex;
          r[hh] += ex * dp[x];
        }
        if (it == nch - 1) {  // rd = r / l, exactly rounded (Markstein, as p divides)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
            l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
            r[hh] += __shfl_xor_sync(0xffffffffu, r[hh], 1);
            r[hh] += __shfl_xor_sync(0xffffffffu, r[hh], 2);
            rcp[hh] = __frcp_rn(l[hh]);
            const float q0 = r[hh] * rcp[hh];
            rd[hh] = fmaf(fmaf(-q0, l[hh], r[hh]), rcp[hh], q0);
          }
          if ((lane & 3) == 0) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              if (hh ? live1 : live0) {
                const int i = row0 + r0 + 8 * hh;
                stt[i] = mx[hh];
                stt[N + i] = l[hh];
                stt[2 * N + i] = rd[hh];
              }
          }
        }
      }
      release_stage(&empty[st], lane);
      continue;
    }

    // ds = p * dp * mask - p * rd (p with the exact divide), then dq += ds K_c
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float d2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * b + 2 * hh + e;
          const float ex = expf(s[x] - mx[hh]);
          const float q0 = ex * rcp[hh];
          const float pv = fmaf(fmaf(-q0, l[hh], ex), rcp[hh], q0);
          d2[e] = live_warp ? pv * dp[x] - pv * rd[hh] : 0.f;
        }
        a[b >> 1][2 * (b & 1) + hh] = pack_bf16(d2[0], d2[1]);
      }
    const uint32_t k_base = ring + st * 2 * KV;  // k read MN-major (its head columns contiguous)
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < 2; ++k16) {
      const uint64_t bk = make_desc(k_base + k16 * 16 * ROWB, SBO, SBO, SW);
      if constexpr (DP == 64)
        wgmma_m64n64k16_rs(dq, a[k16], bk);
      else
        wgmma_m64n32k16_rs(dq, a[k16], bk);
    }
    wgmma_commit();
    fence_acc(dq);
  }
  wgmma_wait<0>();
  fence_acc(dq);
  fence_regs(a[0]);
  fence_regs(a[1]);
  release_stage(&empty[(steps - 1) % LONG_STAGES], lane);

  // dq * scale through this warpgroup's q rows, as the register form writes it
  named_sync(1 + w, WARPGROUP);
#pragma unroll
  for (int b = 0; b < DP / 8; ++b) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(Qs + swz<ROWB>(r0 + 8 * hh, b) + cq * 2) =
          pack_bf16(dq[4 * b + 2 * hh] * p.scale, dq[4 * b + 2 * hh + 1] * p.scale);
  }
  named_sync(1 + w, WARPGROUP);
  const long long ld = 3LL * C, in0 = (long long)g * N * ld;
  const int chunks = Dh / 8;
  for (int e = tid; e < 64 * chunks; e += WARPGROUP) {
    const int rr = w * 64 + e / chunks, cc = e % chunks;
    const int i = row0 + rr;
    if (i < N)
      *reinterpret_cast<uint4*>(p.dqkv + in0 + i * ld + h * Dh + cc * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<ROWB>(rr, cc));
  }
}

// The long form's pass 2 (N > 288): dk and dv of 128 keys of (g, h) on two
// consumer warpgroups, the queries streamed in 32-query chunks with their
// statistics, keep words and bias tiles; per chunk the register form's
// pass-2 body. The head's column sums of ds go to the (G, nH, N) scratch as
// before. ROWS16 (the middle form's pass 2 with an amask at odd N) stages
// the amask rows by 16-byte cp.async from the boundary at or before each row
// (`stage_rows16`; each row's shift staged beside them), where the long
// form copies rows that start 2 bytes off 4 two bytes at a time.
template <int DP, bool ROWS16>
__global__ void __launch_bounds__(LONG_THREADS, 1)
    attention_bwd_dkv_long_kernel(const __grid_constant__ CUtensorMap map_qkv,
                                  const __grid_constant__ CUtensorMap map_do, const Params p) {
  constexpr int ROWB = DP * 2;
  constexpr uint64_t SW = DP == 64 ? SWIZZLE_128B : SWIZZLE_64B;
  constexpr uint32_t SBO = 8 * ROWB;
  constexpr int KV = LONG_CHUNK * ROWB;  // one chunk of q or of dctx
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);      // the block's k, then dk
  unsigned char* Vs = Ks + LONG_ROWS * ROWB;    // its v, then dv
  unsigned char* Ring = Vs + LONG_ROWS * ROWB;  // stage s: q at Ring + 2 s KV, then dctx
  constexpr int AML = ROWS16 ? AM2_LD16 : AM2_LD, AMT = LONG_CHUNK * AML;  // the amask tile's rows
  unsigned char* Qb = Ring + LONG_STAGES * 2 * KV;
  unsigned char* Am = Qb + LONG_STAGES * QB2_TILE;
  unsigned char* Sts = Am + LONG_STAGES * AMT;
  unsigned char* Bt = Sts + LONG_STAGES * ST2_TILE;
  unsigned char* Sh = Bt + LONG_STAGES * BT2_TILE;  // ROWS16: the rows' shifts, qbias's then amask's
  uint64_t* full = reinterpret_cast<uint64_t*>(Sh + (ROWS16 ? LONG_STAGES * SH2_TILE : 0));
  uint64_t* empty = full + LONG_STAGES;
  uint64_t* kvbar = empty + LONG_STAGES;

  const int N = p.N, C = p.C, Dh = p.Dh, nH = p.nH;
  const int kt = blockIdx.x % p.tiles;
  const int gh = blockIdx.x / p.tiles;
  const int h = gh % nH, g = gh / nH;
  const int key0 = kt * LONG_ROWS;
  const int nq = chunks_of(N);  // 32-query chunks
  const float* stt = p.scratch + gh * p.words;
  const int wg = threadIdx.x / WARPGROUP;
  if (threadIdx.x == 0) {
    for (int s = 0; s < LONG_STAGES; ++s) {
      mbar_init(&full[s], 1 + 2 * WARPGROUP);
      mbar_init(&empty[s], 8);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    regs_dec<PRODUCER_REGS>();
    const int t = threadIdx.x;
    if (t == 0) {
      mbar_expect_tx(kvbar, 2 * LONG_ROWS * ROWB);
      for (int r = 0; r < LONG_ROWS; r += LONG_CHUNK) {
        tma_load4(Ks + r * ROWB, &map_qkv, kvbar, 0, nH + h, key0 + r, g);
        tma_load4(Vs + r * ROWB, &map_qkv, kvbar, 0, 2 * nH + h, key0 + r, g);
      }
    }
    const unsigned char* qb0 = reinterpret_cast<const unsigned char*>(p.qbias + (size_t)g * N * N + key0);
    const unsigned char* am0 = reinterpret_cast<const unsigned char*>(p.amask + (size_t)gh * N * N + key0);
    const unsigned char* bits0 = reinterpret_cast<const unsigned char*>(stt + 3 * N + 4 * kt);
    const int clim = N - key0, wlim = nq - 4 * kt;  // keys of the block; its keep words
    for (int it = 0; it < nq; ++it) {
      const int s = it % LONG_STAGES;
      if (it >= LONG_STAGES) mbar_wait(&empty[s], ((it / LONG_STAGES) - 1) & 1);
      const int i0 = it * LONG_CHUNK, rlim = N - i0;
      unsigned char* qst = Ring + s * 2 * KV;
      if (t == 0) {
        mbar_expect_tx(&full[s], 2 * KV);
        tma_load4(qst, &map_qkv, &full[s], 0, h, i0, g);
        tma_load4(qst + KV, &map_do, &full[s], 0, h, i0, g);
      }
      // the three statistics rows (max, sum, rd: N floats apart) of the chunk's
      // queries, and a fourth: RN(1 / sum), once a query for the consumers
      stage_tile<4, 4>(Sts + s * ST2_TILE, LONG_CHUNK * 4, reinterpret_cast<const unsigned char*>(stt + i0), 4LL * N,
                       3, LONG_CHUNK, 3, rlim, t, WARPGROUP);
      if (t < LONG_CHUNK && t < rlim)
        reinterpret_cast<float*>(Sts + s * ST2_TILE)[3 * LONG_CHUNK + t] = __frcp_rn(stt[N + i0 + t]);
      if (p.seed)
        stage_tile<4, 4>(Bt + s * BT2_TILE, 16, bits0 + (size_t)i0 * nq * 4, 4LL * nq, LONG_CHUNK, 4, rlim, wlim, t,
                         WARPGROUP);
      if (p.qbias)
        stage_tile_any<4>(p.qb_unit, Qb + s * QB2_TILE, QB2_LD, qb0 + (size_t)i0 * N * 4, 4LL * N, LONG_CHUNK,
                          LONG_ROWS, rlim, clim, t, WARPGROUP);
      if (p.amask && ROWS16) {
        stage_rows16<AM2_CHUNKS>(Am + s * AMT, AML, am0 + (size_t)i0 * N * 2, 2LL * N,
                                 (clim < LONG_ROWS ? clim : LONG_ROWS) * 2, LONG_CHUNK, rlim, t, WARPGROUP);
        if (t < LONG_CHUNK && t < rlim)
          Sh[s * SH2_TILE + t] =
              static_cast<unsigned char>(reinterpret_cast<uintptr_t>(am0 + (size_t)(i0 + t) * N * 2) & 15);
      } else if (p.amask) {
        stage_tile_any<2>(p.am_unit, Am + s * AMT, AML, am0 + (size_t)i0 * N * 2, 2LL * N, LONG_CHUNK, LONG_ROWS,
                          rlim, clim, t, WARPGROUP);
      }
      stage_arrive(&full[s]);
    }
    cp_async_wait<0>();
    return;
  }

  // the consumers: warpgroup w owns the block's keys 64 w .. 64 w + 63;
  // element x = 4 b + 2 hh + e of a chunk's fragment is key row jl[hh] (of
  // the block), query column cq + 8 b + e (of the chunk)
  regs_inc<CONSUMER_REGS>();
  const int w = wg - 1, tid = threadIdx.x - wg * WARPGROUP;
  const int warp = tid >> 5, lane = tid & 31;
  const int cq = (lane & 3) * 2;
  const int jl[2] = {w * 64 + warp * 16 + (lane >> 2), w * 64 + warp * 16 + (lane >> 2) + 8};
  const bool live_warp = key0 + w * 64 + warp * 16 < N;
  const bool kl[2] = {key0 + jl[0] < N, key0 + jl[1] < N};
  float kbv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) kbv[hh] = p.kbias && kl[hh] ? __ldg(p.kbias + (size_t)g * N + key0 + jl[hh]) : 0.f;
  const uint32_t k_base = smem_u32(Ks + w * 64 * ROWB), v_base = smem_u32(Vs + w * 64 * ROWB);
  const uint32_t ring = smem_u32(Ring);

  float dk[DP / 2], dv[DP / 2], dkb[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) dk[x] = dv[x] = 0.f;
  fence_acc(dk);
  fence_acc(dv);
  uint32_t apa[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}}, ads[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
  float s[16], dp[16], ns[16], ndp[16];  // S^T and dp^T of this step; the next step's, in flight
  mbar_wait(kvbar, 0);
  mbar_wait(&full[0], 0);
  wgmma_rows32_pair<DP>(ns, k_base, ring, ndp, v_base, ring + KV);

#pragma unroll 1
  for (int it = 0; it < nq; ++it) {
    const int st = it % LONG_STAGES, i0 = it * LONG_CHUNK;
    // S^T and dp^T of step it are in (the dk / dv products of step it - 1 may still run)
    if (it > 0)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    fence_acc(ns);
    fence_acc(ndp);
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      s[x] = ns[x];
      dp[x] = ndp[x];
    }
    const bool ahead = it + 1 < nq;
    if (ahead) {
      const uint32_t qn = ring + ((it + 1) % LONG_STAGES) * 2 * KV;
      mbar_wait(&full[(it + 1) % LONG_STAGES], ((it + 1) / LONG_STAGES) & 1);
      wgmma_rows32_pair<DP>(ns, k_base, qn, ndp, v_base, qn + KV);
    }
    if (it > 0) {  // step it - 1's dk / dv products are done: its stage is free
      if (ahead)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence_acc(dk);
      fence_acc(dv);
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16) {
        fence_regs(apa[k16]);
        fence_regs(ads[k16]);
      }
      release_stage(&empty[(it - 1) % LONG_STAGES], lane);
    }

    // per score, branch-free: queries past N (only in the last chunk) and
    // keys past N get pa = ds = 0 by a select (their statistics and tiles
    // are not staged); the mask source and the qbias are a uniform choice
    const float* sm = reinterpret_cast<const float*>(Sts + st * ST2_TILE);  // max, sum, rd, RN(1 / sum)
    const unsigned char* qbs = Qb + st * QB2_TILE;
    const unsigned char* ams = Am + st * AMT;
    const unsigned char* shs = Sh + st * SH2_TILE;  // ROWS16: row il's amask shift at shs[il]
    const uint32_t* bts = reinterpret_cast<const uint32_t*>(Bt + st * BT2_TILE);
    const int qlim = N - i0;  // queries of the chunk below N
    float m[16], qv[16];      // element x: query column cq + 8 b + e, key row jl[hh]
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      m[x] = 1.f;
      qv[x] = 0.f;
    }
    if (p.amask) {
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int il = cq + (x >> 2) * 8 + (x & 1);
        m[x] = __bfloat162float(
            *reinterpret_cast<const bf16*>(ams + il * AML + (ROWS16 ? shs[il] : 0) + jl[(x >> 1) & 1] * 2));
      }
    } else if (p.seed) {
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int j = jl[(x >> 1) & 1];
        m[x] = (bts[(cq + (x >> 2) * 8 + (x & 1)) * 4 + (j >> 5)] >> (j & 31)) & 1u ? p.kept : 0.f;
      }
    }
    if (p.qbias) {
#pragma unroll
      for (int x = 0; x < 16; ++x)
        qv[x] = *reinterpret_cast<const float*>(qbs + (cq + (x >> 2) * 8 + (x & 1)) * QB2_LD + jl[(x >> 1) & 1] * 4);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float mi[2], li[2], ri[2], rc[2];  // the two query columns' statistics
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int il = cq + 8 * b + e;
        mi[e] = sm[il];
        li[e] = sm[LONG_CHUNK + il];
        ri[e] = sm[2 * LONG_CHUNK + il];
        rc[e] = sm[3 * LONG_CHUNK + il];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float pa2[2], ds2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * b + 2 * hh + e;
          // the register form's order: scale, key bias, then qbias (absent: + 0, exact)
          const float v = s[x] * p.scale + kbv[hh] + qv[x];
          const float ex = expf(v - mi[e]);
          const float q0 = ex * rc[e];
          const float pv = fmaf(fmaf(-q0, li[e], ex), rc[e], q0);
          const bool valid = kl[hh] && cq + 8 * b + e < qlim;
          const float pdp = pv * (dp[x] * m[x]);
          const float ds = valid ? pdp - pv * ri[e] : 0.f;
          pa2[e] = valid ? pv * m[x] : 0.f;
          ds2[e] = ds;
          dkb[hh] += ds;
        }
        apa[b >> 1][2 * (b & 1) + hh] = pack_bf16(pa2[0], pa2[1]);
        ads[b >> 1][2 * (b & 1) + hh] = pack_bf16(ds2[0], ds2[1]);
      }
    }
    // dv += pa^T dO_c, dk += ds^T Q_c: 16 query rows a k16 step, read MN-major
    const uint32_t q_base = ring + st * 2 * KV, d_base = q_base + KV;
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < 2; ++k16) {
      const uint64_t bd = make_desc(d_base + k16 * 16 * ROWB, SBO, SBO, SW);
      const uint64_t bq = make_desc(q_base + k16 * 16 * ROWB, SBO, SBO, SW);
      if constexpr (DP == 64) {
        wgmma_m64n64k16_rs(dv, apa[k16], bd);
        wgmma_m64n64k16_rs(dk, ads[k16], bq);
      } else {
        wgmma_m64n32k16_rs(dv, apa[k16], bd);
        wgmma_m64n32k16_rs(dk, ads[k16], bq);
      }
    }
    wgmma_commit();
    fence_acc(dk);
    fence_acc(dv);
  }
  wgmma_wait<0>();
  fence_acc(dk);
  fence_acc(dv);
#pragma unroll
  for (int k16 = 0; k16 < 2; ++k16) {
    fence_regs(apa[k16]);
    fence_regs(ads[k16]);
  }
  release_stage(&empty[(nq - 1) % LONG_STAGES], lane);

  // this head's column sums of ds, one value per key over the row quad (the
  // queries in order, then the quad)
  if (p.dkb_part) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      dkb[hh] += __shfl_xor_sync(0xffffffffu, dkb[hh], 1);
      dkb[hh] += __shfl_xor_sync(0xffffffffu, dkb[hh], 2);
      if ((lane & 3) == 0 && kl[hh]) p.dkb_part[(size_t)gh * N + key0 + jl[hh]] = dkb[hh];
    }
  }

  // dk * scale and dv: bf16 pairs into this warpgroup's k and v rows (its
  // products are done), then 16-byte stores of the keys below N
  named_sync(1 + w, WARPGROUP);
#pragma unroll
  for (int bb = 0; bb < DP / 8; ++bb) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t off = swz<ROWB>(jl[hh], bb) + cq * 2;
      *reinterpret_cast<uint32_t*>(Ks + off) =
          pack_bf16(dk[4 * bb + 2 * hh] * p.scale, dk[4 * bb + 2 * hh + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(Vs + off) = pack_bf16(dv[4 * bb + 2 * hh], dv[4 * bb + 2 * hh + 1]);
    }
  }
  named_sync(1 + w, WARPGROUP);
  const long long ld = 3LL * C, in0 = (long long)g * N * ld;
  const int chunks = Dh / 8;
  for (int e = tid; e < 64 * chunks; e += WARPGROUP) {
    const int r = w * 64 + e / chunks, cc = e % chunks;
    const int j = key0 + r;
    if (j < N) {
      bf16* out = p.dqkv + in0 + j * ld + h * Dh + cc * 8;
      *reinterpret_cast<uint4*>(out + C) = *reinterpret_cast<const uint4*>(Ks + swz<ROWB>(r, cc));
      *reinterpret_cast<uint4*>(out + 2 * C) = *reinterpret_cast<const uint4*>(Vs + swz<ROWB>(r, cc));
    }
  }
}

// The middle form's pass 1 (160 < N <= 288): dq of 128 query rows of (g, h)
// on two consumer warpgroups, the statistics and keep words for pass 2 (the
// long form's); k and v whole in shared memory (one TMA barrier a chunk), S
// computed once and held for the whole row, the softmax in registers as the
// register form's pass 1 runs it, then dp = dO V_c^T chunk by chunk twice
// (rd, then ds and dq += ds K_c), the next chunk's product in flight while
// one is read. The ring carries the bias pass's key-bias and qbias tiles
// (steps 0 .. na - 1, na = NC when either is given, else 0), then the
// amask tiles of the rd pass and of the ds pass (NC steps each when an
// amask is given); the keep words of every chunk are drawn by the producer
// at the start.
template <int NC, int DP>
__global__ void __launch_bounds__(LONG_THREADS, 1)
    attention_bwd_dq_mid_kernel(const __grid_constant__ CUtensorMap map_qkv,
                                const __grid_constant__ CUtensorMap map_do, const Params p) {
  constexpr int ROWB = DP * 2;
  constexpr uint64_t SW = DP == 64 ? SWIZZLE_128B : SWIZZLE_64B;
  constexpr uint32_t SBO = 8 * ROWB;
  constexpr int KR = NC * KEYS;
  constexpr int KV = KEYS * ROWB;  // one chunk of k or of v
  // the ds pass issues chunk c + 1's dp before reading chunk c's where the
  // registers allow (S, dq and two dp chunks: 9 x 64 spills), else after
  // issuing chunk c's dq product
  constexpr bool DS_AHEAD = NC * 16 + DP / 2 <= 144;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Ds = Qs + LONG_ROWS * ROWB;  // dctx's rows
  unsigned char* Ks = Ds + LONG_ROWS * ROWB;
  unsigned char* Vs = Ks + KR * ROWB;
  // stage s at Ring + s * MID_STAGE: a qbias tile and the key bias's 32
  // f32 after it, or an amask tile
  unsigned char* Ring = Vs + KR * ROWB;
  uint32_t* Kw = reinterpret_cast<uint32_t*>(Ring + MID_STAGES * MID_STAGE);  // chunk c's words at Kw + 128 c
  uint64_t* full = reinterpret_cast<uint64_t*>(Kw + NC * LONG_ROWS);
  uint64_t* empty = full + MID_STAGES;
  uint64_t* kbar = empty + MID_STAGES;
  uint64_t* vbar = kbar + NC;
  uint64_t* qbar = vbar + NC;
  uint64_t* kwbar = qbar + 1;

  const int N = p.N, C = p.C, Dh = p.Dh, nH = p.nH;
  const int tile = blockIdx.x % p.tiles;
  const int gh = blockIdx.x / p.tiles;
  const int h = gh % nH, g = gh / nH;
  const int row0 = tile * LONG_ROWS;
  float* stt = p.scratch + gh * p.words;
  uint32_t* bits = reinterpret_cast<uint32_t*>(stt + 3 * N);  // one word per query and 32 keys
  const int live_wgs = row0 + 64 < N ? 2 : 1;  // a consumer warpgroup wholly past N has nothing to do
  const int na = p.kbias || p.qbias ? NC : 0, nm = p.amask ? NC : 0, steps = na + 2 * nm;
  const int wg = threadIdx.x / WARPGROUP;  // 0: the producer; 1, 2: the consumers
  if (threadIdx.x == 0) {
    for (int s = 0; s < MID_STAGES; ++s) {
      mbar_init(&full[s], 2 * WARPGROUP);  // two a producer thread
      mbar_init(&empty[s], 4 * live_wgs);  // lane 0 of each live consumer warp
    }
    for (int c = 0; c < NC; ++c) {
      mbar_init(&kbar[c], 1);
      mbar_init(&vbar[c], 1);
    }
    mbar_init(qbar, 1);
    mbar_init(kwbar, WARPGROUP);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    regs_dec<MID_PRODUCER_REGS>();
    const int t = threadIdx.x;
    if (t == 0) {  // every copy of q, dctx, k and v at once: q and dctx, then k and v chunk by chunk
      mbar_expect_tx(qbar, 2 * LONG_ROWS * ROWB);
#pragma unroll 1
      for (int r = 0; r < LONG_ROWS; r += KEYS) {
        tma_load4(Qs + r * ROWB, &map_qkv, qbar, 0, h, row0 + r, g);
        tma_load4(Ds + r * ROWB, &map_do, qbar, 0, h, row0 + r, g);
      }
#pragma unroll 1
      for (int c = 0; c < NC; ++c) {
        mbar_expect_tx(&kbar[c], KV);
        tma_load4(Ks + c * KV, &map_qkv, &kbar[c], 0, nH + h, c * KEYS, g);
      }
#pragma unroll 1
      for (int c = 0; c < NC; ++c) {
        mbar_expect_tx(&vbar[c], KV);
        tma_load4(Vs + c * KV, &map_qkv, &vbar[c], 0, 2 * nH + h, c * KEYS, g);
      }
    }
    const unsigned char* kb0 = reinterpret_cast<const unsigned char*>(p.kbias + (size_t)g * N);
    const unsigned char* qb0 = reinterpret_cast<const unsigned char*>(p.qbias + ((size_t)g * N + row0) * N);
    const unsigned char* am0 = reinterpret_cast<const unsigned char*>(p.amask + ((size_t)gh * N + row0) * N);
    const int rlim = N - row0;
    if (t == 0) {  // the block's qbias and amask rows into L2 while its first tiles are staged
      if (p.qbias) prefetch_l2(qb0, (size_t)min(rlim, LONG_ROWS) * N * 4);
      if (p.amask) prefetch_l2(am0, (size_t)min(rlim, LONG_ROWS) * N * 2);
    }
    // a chunk's amask tile: rows that start 2 bytes off 4 (odd N) by
    // 16-byte cp.async from the boundary at or before each (shifted), else
    // as the long form stages it
    auto stage_amask = [&](unsigned char* dst, const unsigned char* src, int rlim, int clim, int t) {
      if (p.am_unit == 2)
        stage_rows16<AM_CHUNKS>(dst, AM_LD, src, 2LL * N, min(KEYS, clim) * 2, LONG_ROWS, rlim, t, WARPGROUP);
      else
        stage_tile_any<2>(p.am_unit, dst, AM_LD, src, 2LL * N, LONG_ROWS, KEYS, rlim, clim, t, WARPGROUP);
    };
    // ring steps from .. to - 1
    auto stage = [&](int from, int to) {
#pragma unroll 1
      for (int it = from; it < to; ++it) {
        const int s = it % MID_STAGES;
        if (it >= MID_STAGES) mbar_wait(&empty[s], ((it / MID_STAGES) - 1) & 1);
        const bool bias = it < na;
        const int key0 = (bias ? it : (it - na) % NC) * KEYS, clim = N - key0;
        unsigned char* dst = Ring + s * MID_STAGE;
        if (bias && p.kbias)
          stage_tile_any<4>(p.kb_unit, dst + QB_TILE, 0, kb0 + key0 * 4, 0, 1, KEYS, 1, clim, t, WARPGROUP);
        if (bias && p.qbias)
          stage_tile_any<4>(p.qb_unit, dst, QB_LD, qb0 + key0 * 4, 4LL * N, LONG_ROWS, KEYS, rlim, clim, t,
                            WARPGROUP);
        if (!bias) stage_amask(dst, am0 + key0 * 2, rlim, clim, t);
        stage_arrive(&full[s]);
      }
    };
    stage(0, na);  // the bias pass's tiles first: the consumers need them first
    if (p.seed) {  // row t's keep words of every chunk, two chunks at once, staged and written for pass 2
      const int i = row0 + t;
      const uint32_t key = adrop_key(p.seed), ctr1 = (uint32_t)g * 256u + (uint32_t)(h + p.head0);
#pragma unroll 1
      for (int c = 0; c < NC; c += 2) {
        uint32_t wa = 0u, wb = 0u;
        if (i < N && c + 1 < NC)
          keep_word2(i, c * KEYS, (c + 1) * KEYS, N, key, ctr1, p.thresh, wa, wb);
        else if (i < N)
          wa = keep_word(i, c * KEYS, N, key, ctr1, p.thresh);
        Kw[c * LONG_ROWS + t] = wa;
        if (i < N) bits[i * NC + c] = wa;
        if (c + 1 < NC) {
          Kw[(c + 1) * LONG_ROWS + t] = wb;
          if (i < N) bits[i * NC + c + 1] = wb;
        }
      }
      mbar_arrive(kwbar);
    }
    stage(na, steps);
    cp_async_wait<0>();
    return;
  }

  // the consumers: warpgroup w owns block rows 64 w .. 64 w + 63. Element x
  // = 4 b + 2 hh + e of chunk c's fragment sits in block row r0 + 8 hh, key
  // 32 c + cq + 8 b + e.
  regs_inc<MID_CONSUMER_REGS>();
  const int w = wg - 1, tid = threadIdx.x - wg * WARPGROUP;
  if (w >= live_wgs) return;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = w * 64 + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const bool live_warp = row0 + w * 64 + warp * 16 < N;
  const bool live0 = row0 + r0 < N, live1 = row0 + r0 + 8 < N;
  const uint32_t q_base = smem_u32(Qs + w * 64 * ROWB), d_base = smem_u32(Ds + w * 64 * ROWB);
  const uint32_t k_base = smem_u32(Ks), v_base = smem_u32(Vs);
  // the byte shifts of the thread's two rows in the staged amask tiles
  // (`stage_rows16` at odd N: each row's start mod 16, the same in every
  // chunk; 0 where the rows are staged as the long form stages them)
  const int sha[2] = {p.am_unit == 2 ? row_shift(p.amask, ((size_t)gh * N + row0 + r0) * N, 2) : 0,
                      p.am_unit == 2 ? row_shift(p.amask, ((size_t)gh * N + row0 + r0 + 8) * N, 2) : 0};

  // S = Q K_c^T chunk by chunk as the chunks land, scale and biases, the
  // row max, as K2's middle form
  float s[NC][16];
  mbar_wait(qbar, 0);
  mbar_wait(&kbar[0], 0);
  wgmma_rows32<DP>(s[0], q_base, k_base);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c + 1 < NC) {
      mbar_wait(&kbar[c + 1], 0);
      wgmma_rows32<DP>(s[c + 1], q_base, k_base + (c + 1) * KV);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_acc(s[c]);
    if (na) mbar_wait(&full[c % MID_STAGES], (c / MID_STAGES) & 1);
    if (live_warp) {
      const int st = c % MID_STAGES;
      const float* kbs = reinterpret_cast<const float*>(Ring + st * MID_STAGE + QB_TILE);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int lc = cq + 8 * b;
        const float2 kb2 = p.kbias ? *reinterpret_cast<const float2*>(kbs + lc) : make_float2(0.f, 0.f);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 qb2 =
              p.qbias ? *reinterpret_cast<const float2*>(Ring + st * MID_STAGE + (r0 + 8 * hh) * QB_LD + lc * 4)
                      : make_float2(0.f, 0.f);
          // the register form's order: scale, key bias, then qbias (absent: + 0, exact)
          s[c][4 * b + 2 * hh] = s[c][4 * b + 2 * hh] * p.scale + kb2.x + qb2.x;
          s[c][4 * b + 2 * hh + 1] = s[c][4 * b + 2 * hh + 1] * p.scale + kb2.y + qb2.y;
        }
      }
      if (c == NC - 1 && c * KEYS + KEYS > N) {
#pragma unroll
        for (int x = 0; x < 16; ++x)
          if (c * KEYS + cq + (x >> 2) * 8 + (x & 1) >= N) s[c][x] = -INFINITY;
      }
#pragma unroll
      for (int x = 0; x < 16; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[c][x]);
    }
    if (na) release_stage(&empty[c % MID_STAGES], lane);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
  }

  // the dropout multipliers of elements x, x + 1 (x even) of chunk c, from
  // the ring's stage `st` (amask) or the keep words; keys past N (their
  // tiles are not staged) get 0
  if (p.seed) mbar_wait(kwbar, 0);
  auto mask2 = [&](int c, int st, int x) -> float2 {
    const int hh = (x >> 1) & 1, j = cq + (x >> 2) * 8;  // the pair's first key in the chunk
    float2 m = make_float2(1.f, 1.f);
    if (p.amask) {
      const bf16* ar =
          reinterpret_cast<const bf16*>(Ring + st * MID_STAGE + (r0 + 8 * hh) * AM_LD + sha[hh] + j * 2);
      m = make_float2(__bfloat162float(ar[0]), __bfloat162float(ar[1]));
    } else if (p.seed) {
      const uint32_t kw = Kw[c * LONG_ROWS + r0 + 8 * hh] >> j;
      m = make_float2(kw & 1u ? p.kept : 0.f, kw & 2u ? p.kept : 0.f);
    }
    if (c == NC - 1) {
      if (c * KEYS + j >= N) m.x = 0.f;
      if (c * KEYS + j + 1 >= N) m.y = 0.f;
    }
    return m;
  };

  // p in place of S: exp(s - max) / sum with the exact divide (Markstein's
  // correction of v * RN(1 / sum)), in the register form's order
  float sum[2] = {0.f, 0.f};
  if (live_warp) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
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
  if (live_warp) {
    const float rcp[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int hh = (x >> 1) & 1;
        const float q0 = s[c][x] * rcp[hh];
        s[c][x] = fmaf(fmaf(-q0, sum[hh], s[c][x]), rcp[hh], q0);
      }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (hh ? live1 : live0) {
          const int i = row0 + r0 + 8 * hh;
          stt[i] = mx[hh];
          stt[N + i] = sum[hh];
        }
    }
  }

  // rd = rowsum(p * dp * mask) in the register form's order: dp = dO V_c^T
  // chunk by chunk, the next in flight
  float dp[2][16], rd[2] = {0.f, 0.f};
  mbar_wait(&vbar[0], 0);
  wgmma_rows32<DP>(dp[0], d_base, v_base);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c + 1 < NC) {
      mbar_wait(&vbar[c + 1], 0);
      wgmma_rows32<DP>(dp[(c + 1) & 1], d_base, v_base + (c + 1) * KV);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_acc(dp[c & 1]);
    const int it = na + c, st = it % MID_STAGES;
    if (nm) mbar_wait(&full[st], (it / MID_STAGES) & 1);
    if (live_warp) {
#pragma unroll
      for (int x = 0; x < 16; x += 2) {
        const float2 m = mask2(c, st, x);
        rd[(x >> 1) & 1] += s[c][x] * (dp[c & 1][x] * m.x);
        rd[(x >> 1) & 1] += s[c][x + 1] * (dp[c & 1][x + 1] * m.y);
      }
    }
    if (nm) release_stage(&empty[st], lane);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rd[hh] += __shfl_xor_sync(0xffffffffu, rd[hh], 1);
    rd[hh] += __shfl_xor_sync(0xffffffffu, rd[hh], 2);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (hh ? live1 : live0) stt[2 * N + row0 + r0 + 8 * hh] = rd[hh];
  }

  // ds = p * dp * mask - p * rd in bf16 pairs as the register A operand of
  // dq += ds K_c (k read MN-major); dp again, the next chunk's in flight
  float dq[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) dq[x] = 0.f;
  fence_acc(dq);
  uint32_t a[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
  wgmma_rows32<DP>(dp[0], d_base, v_base);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (DS_AHEAD && c + 1 < NC) {
      wgmma_rows32<DP>(dp[(c + 1) & 1], d_base, v_base + (c + 1) * KV);
      wgmma_wait<1>();  // dp of chunk c and the previous dq product are done
    } else {
      wgmma_wait<0>();
    }
    fence_acc(dp[c & 1]);
    fence_acc(dq);
    fence_regs(a[0]);
    fence_regs(a[1]);
    const int it = na + nm + c, st = it % MID_STAGES;
    if (nm) mbar_wait(&full[st], (it / MID_STAGES) & 1);
#pragma unroll
    for (int x = 0; x < 16; x += 2) {
      const int hh = (x >> 1) & 1;
      float d2[2] = {0.f, 0.f};
      if (live_warp) {
        const float2 m = mask2(c, st, x);
        d2[0] = s[c][x] * (dp[c & 1][x] * m.x) - s[c][x] * rd[hh];
        d2[1] = s[c][x + 1] * (dp[c & 1][x + 1] * m.y) - s[c][x + 1] * rd[hh];
      }
      // x = 4 b + 2 hh .. + 1: k16 step b / 2, register 2 (b % 2) + hh
      a[x >> 3][((x >> 2) & 1) * 2 + hh] = pack_bf16(d2[0], d2[1]);
    }
    if (nm) release_stage(&empty[st], lane);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < 2; ++k16) {
      // 16 key rows of k; one column block, so LBO is unused (given SBO's value)
      const uint64_t bk = make_desc(k_base + c * KV + k16 * 16 * ROWB, SBO, SBO, SW);
      if constexpr (DP == 64)
        wgmma_m64n64k16_rs(dq, a[k16], bk);
      else
        wgmma_m64n32k16_rs(dq, a[k16], bk);
    }
    wgmma_commit();
    if (!DS_AHEAD && c + 1 < NC) wgmma_rows32<DP>(dp[(c + 1) & 1], d_base, v_base + (c + 1) * KV);
  }
  wgmma_wait<0>();
  fence_acc(dq);
  fence_regs(a[0]);
  fence_regs(a[1]);

  // dq * scale through this warpgroup's q rows (its S products are done),
  // as the register form writes it
  named_sync(1 + w, WARPGROUP);
#pragma unroll
  for (int b = 0; b < DP / 8; ++b) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(Qs + swz<ROWB>(r0 + 8 * hh, b) + cq * 2) =
          pack_bf16(dq[4 * b + 2 * hh] * p.scale, dq[4 * b + 2 * hh + 1] * p.scale);
  }
  named_sync(1 + w, WARPGROUP);
  const long long ld = 3LL * C, in0 = (long long)g * N * ld;
  const int chunks = Dh / 8;
  for (int e = tid; e < 64 * chunks; e += WARPGROUP) {
    const int rr = w * 64 + e / chunks, cc = e % chunks;
    const int i = row0 + rr;
    if (i < N)
      *reinterpret_cast<uint4*>(p.dqkv + in0 + i * ld + h * Dh + cc * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<ROWB>(rr, cc));
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

template <int NC, int DP>
cudaError_t launch_dq(const Params& p, unsigned blocks, int smem, cudaStream_t stream) {
  // the most any N of this instance asks (staged amask rows at N = 32 NC)
  constexpr int most = dq_smem(NC * KEYS, DP) + ROWS * NC * KEYS * 2 + 16;
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(attention_bwd_dq_kernel<NC, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  attention_bwd_dq_kernel<NC, DP><<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dispatch_dq(int chunks, const Params& p, unsigned blocks, int smem, cudaStream_t stream) {
  switch (chunks) {
    case 1: return launch_dq<1, DP>(p, blocks, smem, stream);
    case 2: return launch_dq<2, DP>(p, blocks, smem, stream);
    case 3: return launch_dq<3, DP>(p, blocks, smem, stream);
    case 4: return launch_dq<4, DP>(p, blocks, smem, stream);
    case 5: return launch_dq<5, DP>(p, blocks, smem, stream);
    case 6: return launch_dq<6, DP>(p, blocks, smem, stream);
    case 7: return launch_dq<7, DP>(p, blocks, smem, stream);
    case 8: return launch_dq<8, DP>(p, blocks, smem, stream);
    case 9: return launch_dq<9, DP>(p, blocks, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}
static_assert(MAX_CHUNKS == 9, "dispatch_dq covers every chunk count");

template <int DP>
cudaError_t launch_dkv(const Params& p, unsigned blocks, int smem, cudaStream_t stream) {
  static int attr_bytes = 0;  // the opt-in set so far for this instance
  if (smem > attr_bytes) {
    cudaError_t e =
        cudaFuncSetAttribute(attention_bwd_dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_bytes = smem;
  }
  attention_bwd_dkv_kernel<DP><<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NC, int DP>
cudaError_t launch_dq_mid(const CUtensorMap& mqkv, const CUtensorMap& mdo, const Params& p, unsigned blocks,
                          cudaStream_t stream) {
  constexpr int smem = mid_dq_smem(NC * KEYS, DP);  // any N of NC chunks
  static bool attr_set = false;                      // above 48 KB needs the opt-in, once per instance
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(attention_bwd_dq_mid_kernel<NC, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  attention_bwd_dq_mid_kernel<NC, DP><<<blocks, LONG_THREADS, smem, stream>>>(mqkv, mdo, p);
  return cudaGetLastError();
}

// pass 1 of the middle form at `chunks` key chunks (6-9)
template <int DP>
cudaError_t dispatch_dq_mid(int chunks, const CUtensorMap& mqkv, const CUtensorMap& mdo, const Params& p,
                            unsigned blocks, cudaStream_t stream) {
  switch (chunks) {
    case 6: return launch_dq_mid<6, DP>(mqkv, mdo, p, blocks, stream);
    case 7: return launch_dq_mid<7, DP>(mqkv, mdo, p, blocks, stream);
    case 8: return launch_dq_mid<8, DP>(mqkv, mdo, p, blocks, stream);
    case 9: return launch_dq_mid<9, DP>(mqkv, mdo, p, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}
static_assert(MID_MIN_CHUNKS == 6 && MAX_CHUNKS == 9, "dispatch_dq_mid covers every chunk count");

// both passes of a TMA form on `blocks` blocks of 128 rows: the long form's
// (mid_chunks 0), or the middle form's first pass at mid_chunks key chunks
// and the long form's second pass (with an amask at odd N, its rows staged
// 16 bytes at a time)
template <int DP>
cudaError_t launch_long(const void* qkv, const void* dctx, int G, const Params& p, unsigned blocks, int mid_chunks,
                        cudaStream_t stream) {
  // the fused rows as 3 nH heads (q, k, v) and dctx's: their bases are the call's, encoded at every launch
  CUtensorMap mqkv, mdo;
  const long long C = p.C;
  if (!head_rows_map(&mqkv, qkv, p.Dh, 3 * p.nH, p.N, G, p.Dh, 3 * C, 3 * C * p.N, DP, LONG_CHUNK) ||
      !head_rows_map(&mdo, dctx, p.Dh, p.nH, p.N, G, p.Dh, C, C * p.N, DP, LONG_CHUNK))
    return cudaErrorInvalidValue;
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(attention_bwd_dq_long_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, long_dq_smem(DP));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attention_bwd_dkv_long_kernel<DP, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, long_dkv_smem(DP));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attention_bwd_dkv_long_kernel<DP, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, mid_dkv_smem(DP));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cudaError_t e;
  if (mid_chunks) {
    e = dispatch_dq_mid<DP>(mid_chunks, mqkv, mdo, p, blocks, stream);
    if (e != cudaSuccess) return e;
    if (p.amask != nullptr && p.am_unit == 2)  // rows of the amask 2 bytes off 4
      attention_bwd_dkv_long_kernel<DP, true><<<blocks, LONG_THREADS, mid_dkv_smem(DP), stream>>>(mqkv, mdo, p);
    else
      attention_bwd_dkv_long_kernel<DP, false><<<blocks, LONG_THREADS, long_dkv_smem(DP), stream>>>(mqkv, mdo, p);
  } else {
    attention_bwd_dq_long_kernel<DP><<<blocks, LONG_THREADS, long_dq_smem(DP), stream>>>(mqkv, mdo, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    attention_bwd_dkv_long_kernel<DP, false><<<blocks, LONG_THREADS, long_dkv_smem(DP), stream>>>(mqkv, mdo, p);
  }
  return cudaGetLastError();
}

}  // namespace

// Shared memory of K4's larger pass of `form` (0 register, N <= 288; 1 middle, 161 <= N <= 288; 2 long,
// N <= 46,340) for (N, Dh), in pattern mode (bit 0 of flags) or not, with an amask (bit 1) or not, or -1
// where that form does not take them (pattern mode outside the register form, or a head dim that is not
// 16, 32, 48 or 64); the wrapper checks it against the card's opt-in limit.
extern "C" long long mvlt_attention_bwd_smem(int N, int Dh, int flags, int form) {
  return smem_bytes(N, Dh, flags & 1, flags & 2, form);
}

// f32 words of the scratch per (group, head) (row statistics and keep bits), or -1 where K4 does not take
// (N, Dh).
extern "C" long long mvlt_attention_bwd_scratch(int N, int Dh) {
  return long_takes(N, Dh) ? scratch_words(N) : -1;
}

// Chunks of the pattern mode for G groups and P patterns (the wrapper sizes dpat_part with it).
extern "C" int mvlt_attention_bwd_chunks(int G, int P, int nH) {
  if (P < 1 || G % P != 0 || nH < 1) return -1;
  int chunks, wpb;
  pattern_split(G, P, nH, &chunks, &wpb);
  return chunks;
}

// qkv (G*N, 3C), dctx (G*N, C) and dqkv (G*N, 3C) bf16, each 16-byte aligned. pattern (P, nH, N, N) f32
// with G % P == 0, kbias (G, N) f32, qbias (G, N, N) f32 and amask (G, nH, N, N) bf16 may each be null.
// seed: null, or (2,) int32 16-bit halves for mode (a), with K2's thresh and kept; amask must be null with
// it, and head0 + nH <= 256 (head0 keys the draw as in K2). pstore: null, or (G, nH, N, N) bf16 p for mode (b). dkb_part: (G, nH, N) f32 scratch
// and dkbias (G, N) f32, both null to skip the key-bias gradient. With a pattern, dpat_part: (chunks, P,
// nH, N, N) f32 scratch (`mvlt_attention_bwd_chunks`) and dpattern (P, nH, N, N) f32. scratch: (G, nH,
// `mvlt_attention_bwd_scratch`) f32, the first pass's statistics for the second. form: 0 the register
// form, 1 the middle form, 2 the long form (`mvlt_attention_bwd_smem`); in the middle and long forms
// pattern and pstore must be null.
extern "C" int mvlt_attention_bwd(const void* qkv, const void* dctx, const void* pattern, const void* kbias,
                                  const void* qbias, const void* amask, const void* seed, const void* pstore,
                                  void* dqkv, void* dkb_part, void* dkbias, void* dpat_part, void* dpattern,
                                  void* scratch, int G, int N, int C, int nH, int P, float scale,
                                  unsigned int thresh, float kept, int head0, int form, void* stream) {
  if (G < 1 || nH < 1 || C % nH != 0 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int Dh = C / nH;
  const long long smem = smem_bytes(N, Dh, pattern != nullptr, amask != nullptr, form);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if (seed != nullptr && (amask != nullptr || head0 < 0 || head0 + nH > 256)) return (int)cudaErrorInvalidValue;
  const bool long_form = form == FORM_LONG, staged = form != FORM_REGISTER;  // TMA blocks of 128 rows
  if (staged && (pattern != nullptr || pstore != nullptr)) return (int)cudaErrorInvalidValue;
  // the middle form stages an amask's rows from the 16-byte boundary at or before each
  if (form == FORM_MIDDLE && ((uintptr_t)amask & 15)) return (int)cudaErrorInvalidValue;
  if ((dkb_part == nullptr) != (dkbias == nullptr)) return (int)cudaErrorInvalidValue;
  if (pattern != nullptr && (P < 1 || G % P != 0 || dpat_part == nullptr || dpattern == nullptr))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)qkv | (uintptr_t)dctx | (uintptr_t)dqkv) & 15) return (int)cudaErrorInvalidValue;
  const int optin = smem_optin();
  if (optin < 0 || smem > optin) return (int)cudaErrorInvalidValue;
  const int tiles = staged ? (N + LONG_ROWS - 1) / LONG_ROWS : (N + ROWS - 1) / ROWS;
  int chunks = 1, wpb = 1, stride = G, per = 1;  // without a pattern: one group a block
  if (pattern != nullptr) {
    pattern_split(G, P, nH, &chunks, &wpb);
    stride = P;
    per = G / P;
  }
  const long long dq_blocks = (long long)G * nH * tiles, dkv_blocks = (long long)tiles * nH * stride * chunks;
  if (dq_blocks > 0x7fffffffLL || dkv_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the long form's bias-tile copies: the widest unit every row start allows
  const int qb_unit = stage_unit(qbias, N, 4), am_unit = stage_unit(amask, N, 2), kb_unit = stage_unit(kbias, N, 4);
  using cbf = const bf16*;
  const Params p{static_cast<cbf>(qkv), static_cast<cbf>(dctx), static_cast<const float*>(pattern),
                 static_cast<const float*>(kbias), static_cast<const float*>(qbias), static_cast<cbf>(amask),
                 static_cast<const int*>(seed), static_cast<cbf>(pstore), static_cast<bf16*>(dqkv),
                 static_cast<float*>(dkb_part), static_cast<float*>(dpat_part), static_cast<float*>(scratch),
                 scratch_words(N), N, C, nH, Dh, pattern != nullptr ? P : 1, tiles,
                 !staged && amask != nullptr && dq_mask_smem(N, Dh) > 0, stride, per, wpb, qb_unit, am_unit,
                 kb_unit, scale, thresh, kept, head0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = chunks_of(N), wide = head_cols(Dh) == 64;
  cudaError_t e;
  if (staged) {  // both passes on G * nH * tiles blocks; the middle form's second pass is the long form's
    e = wide ? launch_long<64>(qkv, dctx, G, p, (unsigned)dq_blocks, long_form ? 0 : nc, s)
             : launch_long<32>(qkv, dctx, G, p, (unsigned)dq_blocks, long_form ? 0 : nc, s);
  } else {
    const int q_smem = dq_smem(N, Dh) + (p.mask_staged ? dq_mask_smem(N, Dh) : 0);
    e = wide ? dispatch_dq<64>(nc, p, (unsigned)dq_blocks, q_smem, s)
             : dispatch_dq<32>(nc, p, (unsigned)dq_blocks, q_smem, s);
    if (e != cudaSuccess) return (int)e;
    const int kv_smem = dkv_smem(N, Dh) + (pattern != nullptr ? pattern_smem(N) : 0);
    e = wide ? launch_dkv<64>(p, (unsigned)dkv_blocks, kv_smem, s)
             : launch_dkv<32>(p, (unsigned)dkv_blocks, kv_smem, s);
  }
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
