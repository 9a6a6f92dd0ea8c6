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
// runs at S = 298 / 348 (ViT-B/16 or the linear patch with 100 / 150 text
// tokens) and 474 (two IU X-Ray views). Neither shared memory nor registers
// grow with N. The keys stream in 32-key chunks through two sweeps:
//   1. S = Q K_c^T, scale and biases, then each row's max and its sum of
//      exponentials. The sum is kept against the running max and rescaled
//      by exp(old max - new max) (1 where the max holds) chunk by chunk, so
//      it is the sum against the row's final max up to that rescaling's
//      rounding;
//   2. S again, p = exp(s - max) / sum with the exact divide, times the
//      amask or the Philox keep mask, rounded to bf16 and accumulated as
//      P V_c in f32.
// Why not FlashAttention's one-pass rescaled accumulator: the two sweeps
// keep the rounding points that the register form and JAX's interpret path
// share (p normalised in f32 before its bf16 rounding, PV summed once).
// A key-bias call reads only q, k, v and the key bias, so its bound is bytes;
// what stands between a block and it is the chain of copies, products,
// exponentials and reductions of each chunk, and the scalar work itself.
// The design (it also takes N <= 288 when a caller asks for it by form, so
// the forms can be timed against each other at one N):
//   - a block of three warpgroups owns 128 query rows of one (group, head),
//     one block an SM. Warpgroups 0 and 1 are the consumers, 64 rows each,
//     and share every chunk: each chunk is copied once for 128 rows.
//     Warpgroup 2 is the producer: one thread keeps a ring of LONG_STAGES
//     stages full by TMA (q's 128 rows once, then each step's 32-key chunk
//     of k, and in the second sweep v, as boxes of a 4-D tensor map over
//     (head dim, heads, rows, groups): rows past N and the padding columns
//     of head dims 16 / 48 arrive as zeros), and its 128 threads stage the
//     chunk's key bias, qbias tile (128 rows x 32 keys, f32) and, in the
//     second sweep, amask tile (bf16) beside it by 8- or 4-byte cp.async,
//     one column a thread down strided rows (rows of N f32 or bf16 need not
//     start on 16 bytes, so TMA cannot take them; a bf16 amask whose rows
//     start 2 bytes off 4, at odd N, is copied with plain loads). With
//     in-kernel dropout the producer thread of each row draws its keep word
//     of the chunk (`keep_word`, philox.cuh) into the stage as well. Each
//     stage's `full` barrier completes on the TMA bytes and two arrivals a
//     producer thread (one releasing its stores, one on its cp.async);
//     `setmaxnreg` hands the producer's registers to the consumers;
//   - the bias tiles' rows are padded so that the per-score reads of the
//     wgmma fragment layout come from shared memory without bank conflicts,
//     and the per-score work is branch-free: rows past N add whatever their
//     tile rows hold (they feed only rows that are never stored), keys past
//     N are masked in the last chunk alone;
//   - the next chunk's S product is issued before this chunk's softmax runs
//     and waited for one step later (`wgmma_wait` leaves the newest group in
//     flight), so the tensor cores work under the exponentials; a stage is
//     handed back (`empty` barrier, one arrival per consumer warp) once the
//     products and reads of it are done.
// It takes the sequence modes only (key bias, qbias, amask, in-kernel
// dropout): the pattern and stored-p modes keep the register form and its N
// <= 288, and the wrapper keeps the head-major layout there too (no path
// runs a window past 144). N is capped at 46,340 so that i * N + j stays a
// 32-bit index (and a 32-bit Philox counter word).
//
// The middle form (`attention_mid_kernel<NC, DP>`, 160 < N <= 288, the
// sequence modes): the fusion encoder's lengths on the other entry points
// (the two-view caption and retrieval steps' 180, the caption step's 201,
// ViT-B/16 and the linear patch's 221 and 278). There the register form,
// stretched from 131 to 288 keys, loses to one SDPA call by 2.5-3.6x: one
// warpgroup a block on 64 rows, a register cap of two blocks an SM (eight
// warps to hide each block's chain), every block copying all N keys of k and
// v by cp.async before its first product (each (g, h) reads them
// ceil(N / 64) times), and the key bias read score by score from device
// memory. The long form would take these N, but sweeps the keys twice
// because its rows do not fit; here they do: a whole row of scores is at
// most nine 32-key chunks, 144 f32 registers a consumer thread, and k and v
// fit shared memory whole (73,728 bytes at N = 288, head dim 64). So the
// middle form is the long form's block, three warpgroups on 128 query rows,
// with one sweep:
//   - the producer thread issues every TMA load at once: q's 128 rows, then
//     k and v chunk by chunk, each 32-key chunk on an mbarrier of its own,
//     so the S product of chunk 0 starts while the rest are in flight and
//     each (g, h) reads k and v ceil(N / 128) times; it asks the block's
//     qbias and amask rows into L2 (a bulk prefetch). The producer's 128
//     threads stage the chunks' key-bias and qbias tiles (the bias pass),
//     then draw the keep words of every chunk (in-kernel dropout; one row a
//     thread, two chunks' Philox calls interleaved), then stage the amask
//     tiles (the P V pass), through a ring of MID_STAGES stages that holds
//     a qbias tile and the key bias or an amask tile, as the long form
//     stages them, but for an amask at odd N: its rows start 2 bytes off 4,
//     and where the long form copies them 2 bytes at a time (what held it
//     back at 201 and 221 with a mask) they are copied 16 bytes at a time
//     from the boundary at or before each row (`stage_rows16`, each row's
//     shift taken at the reads);
//   - each consumer warpgroup issues S = Q K_c^T chunk by chunk as the
//     chunks land (one commit group each, the next in flight while this one
//     takes its scale and biases), then the exact row max, the
//     exponentials and their sum, the exact divide, p (x amask / keep)
//     rounded to bf16 as the register A operand of P V_c, one commit group
//     a chunk with no wait until the last;
//   - 232 registers a consumer thread (`setmaxnreg`; the producer keeps 40)
//     hold the row's scores, P V's accumulator and p's bf16 pairs (ptxas
//     spills some 100 bytes at 8-9 chunks of head dim 64); a consumer
//     warpgroup whose rows all lie past N returns at once.
// The arithmetic is the register form's, in its order: ctx is the register
// form's bit for bit (the card's `--mid-n` checks compare them).
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
// the long form: query rows a block (two consumer warpgroups), keys a chunk
// (one m64n32 product), ring stages, the largest N (i * N + j in 32 bits),
// the block (two consumer warpgroups and a producer) and the registers
// `setmaxnreg` gives each (128 x 56 + 256 x 224 = 384 x 168)
constexpr int LONG_ROWS = 128, LONG_KEYS = 32, LONG_STAGES = 4;
constexpr int LONG_MAX_N = 46340;
constexpr int LONG_THREADS = 3 * WARPGROUP, PRODUCER_REGS = 56, CONSUMER_REGS = 224;
// the staged bias tiles of a stage: qbias 128 rows of 32 f32 padded to 160
// bytes, amask 128 rows of 32 bf16 padded to 80 (rows 8 apart then start 8
// or 4 banks apart: a warp's fragment reads hit each bank once a wavefront),
// the key bias's 32 f32
constexpr int QB_LD = 160, AM_LD = 80;
constexpr int QB_TILE = LONG_ROWS * QB_LD, AM_TILE = LONG_ROWS * AM_LD, KB_TILE = LONG_KEYS * 4;
// in-kernel dropout: each row's keep word of the chunk (bit j keeps key key0 + j)
constexpr int KW_TILE = LONG_ROWS * 4;
// the long form past N = 288, and at any N a caller asks it for by form
__host__ __device__ constexpr bool long_takes(int N, int Dh) {
  return N >= 1 && N <= LONG_MAX_N && Dh >= 16 && Dh <= 64 && Dh % 16 == 0;
}
// 1024 bytes of slack for the swizzle's alignment, q's 128 rows, the ring's k
// and v chunks, its bias tiles and keep words, 128 bytes of mbarriers
__host__ __device__ constexpr int long_bytes(int Dh) {
  return 1024 + (LONG_ROWS + LONG_STAGES * 2 * LONG_KEYS) * head_cols(Dh) * 2 +
         LONG_STAGES * (QB_TILE + AM_TILE + KB_TILE + KW_TILE) + 128;
}
// the forms of a launch (`form` of `mvlt_attention`; ops/kernels.py
// ATTENTION_FORMS): the plan in Python picks one for each N and mode
constexpr int FORM_REGISTER = 0, FORM_MIDDLE = 1, FORM_LONG = 2;
// the middle form: 6-9 key chunks (161 <= N <= 288), the ring's stages of
// bias tiles, the registers `setmaxnreg` gives the producer and each
// consumer (128 x 40 + 256 x 232 = 384 x 168)
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
// 1024 bytes of slack for the swizzle's alignment, q's 128 rows, k and v
// over whole chunks, the ring's stages, the keep words of every chunk, 256
// bytes of mbarriers
__host__ __device__ constexpr int mid_bytes(int N, int Dh) {
  return 1024 + (LONG_ROWS + 2 * ((N + KEYS - 1) / KEYS) * KEYS) * head_cols(Dh) * 2 + MID_STAGES * MID_STAGE +
         ((N + KEYS - 1) / KEYS) * KW_TILE + 256;
}
// shared memory of one block of the given form, or -1 where that form does
// not take (N, Dh)
__host__ __device__ constexpr long long smem_bytes(int N, int Dh, bool amask, int form) {
  return form == FORM_REGISTER ? (takes(N, Dh) ? base_bytes(N, Dh) + (amask ? mask_bytes(N, Dh) : 0) : -1)
         : form == FORM_MIDDLE ? (mid_takes(N, Dh) ? mid_bytes(N, Dh) : -1)
         : form == FORM_LONG   ? (long_takes(N, Dh) ? long_bytes(Dh) : -1)
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
  int qb_unit, am_unit, kb_unit;  // the long form's bias-tile copies (`stage_unit`)
  float scale;
  uint32_t thresh;
  float kept;
  int head0;  // mode (a): the global index of head 0 (a tensor-parallel rank's heads)
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
    const uint32_t key = adrop_key(p.seed), ctr1 = (uint32_t)g * 256u + (uint32_t)(h + p.head0);
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

// The long form (N > 288): 128 query rows of one (group, head) on two
// consumer warpgroups, the keys streamed in 32-key chunks by a producer
// warpgroup, two sweeps (see the head of the file). Step `it` of the 2 * nch
// steps is chunk it % nch of sweep it / nch, in ring stage it % LONG_STAGES.
template <int DP>
__global__ void __launch_bounds__(LONG_THREADS, 1)
    attention_long_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, const Params p) {
  constexpr int ROWB = DP * 2;
  constexpr uint64_t SW = DP == 64 ? SWIZZLE_128B : SWIZZLE_64B;
  constexpr uint32_t SBO = 8 * ROWB;
  constexpr int KV = LONG_KEYS * ROWB;  // one chunk of k or of v
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Ring = Qs + LONG_ROWS * ROWB;  // stage s: k at Ring + 2 s KV, then v
  unsigned char* Qb = Ring + LONG_STAGES * 2 * KV;
  unsigned char* Am = Qb + LONG_STAGES * QB_TILE;
  unsigned char* Kb = Am + LONG_STAGES * AM_TILE;
  uint32_t* Kw = reinterpret_cast<uint32_t*>(Kb + LONG_STAGES * KB_TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(Kw + LONG_STAGES * LONG_ROWS);
  uint64_t* empty = full + LONG_STAGES;
  uint64_t* qbar = empty + LONG_STAGES;

  const int N = p.N;
  const int tile = blockIdx.x % p.tiles;
  const int gh = blockIdx.x / p.tiles;
  const int h = gh % p.nH, g = gh / p.nH;
  const int row0 = tile * LONG_ROWS;
  const int nch = (N + LONG_KEYS - 1) / LONG_KEYS, steps = 2 * nch;
  const int wg = threadIdx.x / WARPGROUP;  // 0, 1: the consumers; 2: the producer
  if (threadIdx.x == 0) {
    for (int s = 0; s < LONG_STAGES; ++s) {
      mbar_init(&full[s], 1 + 2 * WARPGROUP);  // the TMA thread's expect_tx + two a producer thread
      mbar_init(&empty[s], 8);                  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer
    regs_dec<PRODUCER_REGS>();
    const int t = threadIdx.x - 2 * WARPGROUP;
    if (t == 0) {
      mbar_expect_tx(qbar, LONG_ROWS * ROWB);
      for (int r = 0; r < LONG_ROWS; r += LONG_KEYS) tma_load4(Qs + r * ROWB, &map_q, qbar, 0, h, row0 + r, g);
    }
    const unsigned char* kb0 = reinterpret_cast<const unsigned char*>(p.kbias + (size_t)g * N);
    const unsigned char* qb0 = reinterpret_cast<const unsigned char*>(p.qbias + ((size_t)g * N + row0) * N);
    const unsigned char* am0 = reinterpret_cast<const unsigned char*>(p.amask + ((size_t)gh * N + row0) * N);
    const int rlim = N - row0;
    const uint32_t key = p.seed ? adrop_key(p.seed) : 0u, ctr1 = (uint32_t)g * 256u + (uint32_t)(h + p.head0);
    float* mo = p.mask_out ? p.mask_out + (size_t)gh * N * N : nullptr;
    for (int it = 0; it < steps; ++it) {
      const int s = it % LONG_STAGES;
      if (it >= LONG_STAGES) mbar_wait(&empty[s], ((it / LONG_STAGES) - 1) & 1);
      const bool second = it >= nch;
      const int key0 = (second ? it - nch : it) * LONG_KEYS, clim = N - key0;
      unsigned char* kst = Ring + s * 2 * KV;
      if (t == 0) {
        mbar_expect_tx(&full[s], (second ? 2 : 1) * KV);
        tma_load4(kst, &map_k, &full[s], 0, h, key0, g);
        if (second) tma_load4(kst + KV, &map_v, &full[s], 0, h, key0, g);
      }
      if (p.kbias)
        stage_tile_any<4>(p.kb_unit, Kb + s * KB_TILE, 0, kb0 + key0 * 4, 0, 1, LONG_KEYS, 1, clim, t, WARPGROUP);
      if (p.qbias)
        stage_tile_any<4>(p.qb_unit, Qb + s * QB_TILE, QB_LD, qb0 + key0 * 4, 4LL * N, LONG_ROWS, LONG_KEYS, rlim,
                          clim, t, WARPGROUP);
      if (second && p.amask)
        stage_tile_any<2>(p.am_unit, Am + s * AM_TILE, AM_LD, am0 + key0 * 2, 2LL * N, LONG_ROWS, LONG_KEYS, rlim,
                          clim, t, WARPGROUP);
      if (second && p.seed) {  // row t's keep word of the chunk (and, asked for, the mask it draws)
        const int i = row0 + t;
        const uint32_t wd = i < N ? keep_word(i, key0, N, key, ctr1, p.thresh) : 0u;
        Kw[s * LONG_ROWS + t] = wd;
        if (mo != nullptr && i < N)
          for (int j = 0; j < LONG_KEYS && j < clim; ++j) mo[(size_t)i * N + key0 + j] = (wd >> j) & 1u ? p.kept : 0.f;
      }
      stage_arrive(&full[s]);
    }
    cp_async_wait<0>();
    return;
  }

  // the consumers: warpgroup w owns block rows 64 w .. 64 w + 63. Element x
  // of a chunk's fragment sits in block row r0 + 8 hh, chunk column cq +
  // (x >> 2) * 8 + (x & 1), x = 4 b + 2 hh + e.
  regs_inc<CONSUMER_REGS>();
  const int w = wg, tid = threadIdx.x - wg * WARPGROUP;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = w * 64 + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const bool live_warp = row0 + w * 64 + warp * 16 < N;
  const uint32_t q_base = smem_u32(Qs + w * 64 * ROWB), ring = smem_u32(Ring);

  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, rcp[2] = {0.f, 0.f};
  float o[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
  fence_acc(o);
  uint32_t a[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};  // p in bf16: the A operand of P V
  float s[16], nxt[16];  // S of this step; the next step's, in flight
  mbar_wait(qbar, 0);
  mbar_wait(&full[0], 0);
  wgmma_rows32<DP>(nxt, q_base, ring);

#pragma unroll 1
  for (int it = 0; it < steps; ++it) {
    const bool second = it >= nch;
    const int c0 = (second ? it - nch : it) * LONG_KEYS;
    const int st = it % LONG_STAGES;
    // S of step it is in (P V of step it - 1 may still run)
    if (it > nch)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    fence_acc(nxt);
#pragma unroll
    for (int x = 0; x < 16; ++x) s[x] = nxt[x];
    const bool ahead = it + 1 < steps;
    if (ahead) {  // the next step's S runs under this step's softmax
      mbar_wait(&full[(it + 1) % LONG_STAGES], ((it + 1) / LONG_STAGES) & 1);
      wgmma_rows32<DP>(nxt, q_base, ring + ((it + 1) % LONG_STAGES) * 2 * KV);
    }
    if (it > nch) {  // P V of step it - 1 is done: its stage is free, a may be rewritten
      if (ahead)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence_acc(o);
      fence_regs(a[0]);
      fence_regs(a[1]);
      release_stage(&empty[(it - 1) % LONG_STAGES], lane);
    }

    // scale and biases from the stage's tiles. Branch-free per score: rows
    // past N take whatever their tile rows hold (they feed only rows that
    // are never stored); keys past N, only in the last chunk (a uniform
    // branch), are -inf, and their amask 0
    const bool tail = c0 + LONG_KEYS > N;
    if (live_warp) {
      const unsigned char* qbr = Qb + st * QB_TILE + r0 * QB_LD;
      const float* kbs = reinterpret_cast<const float*>(Kb + st * KB_TILE);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int lc = cq + 8 * b;  // the pair's first chunk column
        const float2 kb2 = p.kbias ? *reinterpret_cast<const float2*>(kbs + lc) : make_float2(0.f, 0.f);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 qb2 =
              p.qbias ? *reinterpret_cast<const float2*>(qbr + hh * 8 * QB_LD + lc * 4) : make_float2(0.f, 0.f);
          // the register form's order: scale, key bias, then qbias (absent: + 0, exact)
          s[4 * b + 2 * hh] = s[4 * b + 2 * hh] * p.scale + kb2.x + qb2.x;
          s[4 * b + 2 * hh + 1] = s[4 * b + 2 * hh + 1] * p.scale + kb2.y + qb2.y;
        }
      }
      if (tail) {
#pragma unroll
        for (int x = 0; x < 16; ++x)
          if (c0 + cq + (x >> 2) * 8 + (x & 1) >= N) s[x] = -INFINITY;
      }
    }

    if (!second) {
      if (live_warp) {
        // the chunk's row max over the quad, then the running sum rescaled
        // to the new max (by 1 where it holds; 0 before the first chunk)
        float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int x = 0; x < 16; ++x) cm[(x >> 1) & 1] = fmaxf(cm[(x >> 1) & 1], s[x]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          cm[hh] = fmaxf(cm[hh], __shfl_xor_sync(0xffffffffu, cm[hh], 1));
          cm[hh] = fmaxf(cm[hh], __shfl_xor_sync(0xffffffffu, cm[hh], 2));
          const float nm = fmaxf(mx[hh], cm[hh]);  // finite: every chunk holds a key below N
          sum[hh] *= expf(mx[hh] - nm);
          mx[hh] = nm;
        }
#pragma unroll
        for (int x = 0; x < 16; ++x) sum[(x >> 1) & 1] += expf(s[x] - mx[(x >> 1) & 1]);
        if (it == nch - 1) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
            sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
            rcp[hh] = __frcp_rn(sum[hh]);
          }
        }
      }
      release_stage(&empty[st], lane);
      continue;
    }

    // the second sweep: p = exp(s - max) / sum (Markstein's exact divide, as
    // the register form), the dropout multiplier, bf16 pairs for P V
    if (live_warp) {
      const unsigned char* amr = Am + st * AM_TILE + r0 * AM_LD;
      float m[16];
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 m2 =
              p.amask ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(amr + hh * 8 * AM_LD +
                                                                                    (cq + 8 * b) * 2))
                      : make_float2(1.f, 1.f);
          m[4 * b + 2 * hh] = m2.x;
          m[4 * b + 2 * hh + 1] = m2.y;
        }
      if (p.seed) {  // the rows' keep words, drawn by the producer
        const uint32_t kw[2] = {Kw[st * LONG_ROWS + r0], Kw[st * LONG_ROWS + r0 + 8]};
#pragma unroll
        for (int x = 0; x < 16; ++x) m[x] = (kw[(x >> 1) & 1] >> (cq + (x >> 2) * 8 + (x & 1))) & 1u ? p.kept : 0.f;
      }
      if (tail) {
#pragma unroll
        for (int x = 0; x < 16; ++x)
          if (c0 + cq + (x >> 2) * 8 + (x & 1) >= N) m[x] = 0.f;
      }
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float pv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * b + 2 * hh + e;
            const float ex = expf(s[x] - mx[hh]);
            const float q0 = ex * rcp[hh];
            pv[e] = fmaf(fmaf(-q0, sum[hh], ex), rcp[hh], q0) * m[x];
          }
          // x = 4 b + 2 hh .. + 1: k16 step b / 2, register 2 (b % 2) + hh
          a[b >> 1][2 * (b & 1) + hh] = pack_bf16(pv[0], pv[1]);
        }
    } else {
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16)
#pragma unroll
        for (int q = 0; q < 4; ++q) a[k16][q] = 0u;
    }
    // O += P V_c: A from registers, v MN-major (its head columns contiguous)
    const uint32_t v_base = ring + st * 2 * KV + KV;
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < 2; ++k16) {
      const uint64_t dv = make_desc(v_base + k16 * 16 * ROWB, SBO, SBO, SW);
      if constexpr (DP == 64)
        wgmma_m64n64k16_rs(o, a[k16], dv);
      else
        wgmma_m64n32k16_rs(o, a[k16], dv);
    }
    wgmma_commit();
    fence_acc(o);
  }
  wgmma_wait<0>();
  fence_acc(o);
  fence_regs(a[0]);
  fence_regs(a[1]);
  release_stage(&empty[(steps - 1) % LONG_STAGES], lane);

  // ctx through this warpgroup's q rows (its S products are done), then
  // 16-byte stores of the rows below N
  named_sync(1 + w, WARPGROUP);
#pragma unroll
  for (int b = 0; b < DP / 8; ++b) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(Qs + swz<ROWB>(r0 + 8 * hh, b) + cq * 2) =
          pack_bf16(o[4 * b + 2 * hh], o[4 * b + 2 * hh + 1]);
  }
  named_sync(1 + w, WARPGROUP);
  const long long out0 = g * p.out_g + h * p.out_h;
  const int chunks = p.Dh / 8;
  for (int e = tid; e < 64 * chunks; e += WARPGROUP) {
    const int r = w * 64 + e / chunks, c = e % chunks;
    const int i = row0 + r;
    if (i < N)
      *reinterpret_cast<uint4*>(p.ctx + out0 + i * p.out_n + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<ROWB>(r, c));
  }
}

// The middle form (160 < N <= 288): 128 query rows of one (group, head) on
// two consumer warpgroups, k and v whole in shared memory (one TMA barrier a
// chunk), the row's scores in registers, one sweep (see the head of the
// file). The ring carries the bias pass's key-bias and qbias tiles (steps 0
// .. na - 1, na = NC when either is given, else 0), then the P V pass's
// amask tiles (steps na .. na + NC - 1 when an amask is given).
template <int NC, int DP>
__global__ void __launch_bounds__(LONG_THREADS, 1)
    attention_mid_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, const Params p) {
  constexpr int ROWB = DP * 2;
  constexpr uint64_t SW = DP == 64 ? SWIZZLE_128B : SWIZZLE_64B;
  constexpr uint32_t SBO = 8 * ROWB;
  constexpr int KR = NC * KEYS;
  constexpr int KV = KEYS * ROWB;  // one chunk of k or of v
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Ks = Qs + LONG_ROWS * ROWB;
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

  const int N = p.N;
  const int tile = blockIdx.x % p.tiles;
  const int gh = blockIdx.x / p.tiles;
  const int h = gh % p.nH, g = gh / p.nH;
  const int row0 = tile * LONG_ROWS;
  const int live_wgs = row0 + 64 < N ? 2 : 1;  // a consumer warpgroup wholly past N has nothing to do
  const int na = p.kbias || p.qbias ? NC : 0, steps = na + (p.amask ? NC : 0);
  const int wg = threadIdx.x / WARPGROUP;  // 0, 1: the consumers; 2: the producer
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

  if (wg == 2) {  // the producer
    regs_dec<MID_PRODUCER_REGS>();
    const int t = threadIdx.x - 2 * WARPGROUP;
    if (t == 0) {  // every copy of q, k and v at once: q, then k and v chunk by chunk
      mbar_expect_tx(qbar, LONG_ROWS * ROWB);
#pragma unroll 1
      for (int r = 0; r < LONG_ROWS; r += KEYS) tma_load4(Qs + r * ROWB, &map_q, qbar, 0, h, row0 + r, g);
#pragma unroll 1
      for (int c = 0; c < NC; ++c) {
        mbar_expect_tx(&kbar[c], KV);
        tma_load4(Ks + c * KV, &map_k, &kbar[c], 0, h, c * KEYS, g);
      }
#pragma unroll 1
      for (int c = 0; c < NC; ++c) {
        mbar_expect_tx(&vbar[c], KV);
        tma_load4(Vs + c * KV, &map_v, &vbar[c], 0, h, c * KEYS, g);
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
        const bool pv = it >= na;
        const int key0 = (pv ? it - na : it) * KEYS, clim = N - key0;
        unsigned char* dst = Ring + s * MID_STAGE;
        if (!pv && p.kbias)
          stage_tile_any<4>(p.kb_unit, dst + QB_TILE, 0, kb0 + key0 * 4, 0, 1, KEYS, 1, clim, t, WARPGROUP);
        if (!pv && p.qbias)
          stage_tile_any<4>(p.qb_unit, dst, QB_LD, qb0 + key0 * 4, 4LL * N, LONG_ROWS, KEYS, rlim, clim, t,
                            WARPGROUP);
        if (pv) stage_amask(dst, am0 + key0 * 2, rlim, clim, t);
        stage_arrive(&full[s]);
      }
    };
    stage(0, na);  // the bias pass's tiles first: the consumers need them first
    if (p.seed) {  // row t's keep words of every chunk, two chunks at once (and, asked for, the mask they draw)
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
        if (c + 1 < NC) Kw[(c + 1) * LONG_ROWS + t] = wb;
      }
      if (p.mask_out != nullptr && i < N) {
        float* mo = p.mask_out + ((size_t)gh * N + i) * N;
        for (int j = 0; j < N; ++j) mo[j] = (Kw[(j / KEYS) * LONG_ROWS + t] >> (j % KEYS)) & 1u ? p.kept : 0.f;
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
  const int w = wg, tid = threadIdx.x - wg * WARPGROUP;
  if (w >= live_wgs) return;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = w * 64 + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const bool live_warp = row0 + w * 64 + warp * 16 < N;
  const uint32_t q_base = smem_u32(Qs + w * 64 * ROWB), k_base = smem_u32(Ks), v_base = smem_u32(Vs);
  // the byte shifts of the thread's two rows in the staged amask tiles
  // (`stage_rows16` at odd N: each row's start mod 16, the same in every
  // chunk; 0 where the rows are staged as the long form stages them)
  const int sha[2] = {p.am_unit == 2 ? row_shift(p.amask, ((size_t)gh * N + row0 + r0) * N, 2) : 0,
                      p.am_unit == 2 ? row_shift(p.amask, ((size_t)gh * N + row0 + r0 + 8) * N, 2) : 0};

  // S = Q K_c^T chunk by chunk as the chunks land, one commit group each;
  // chunk c takes its scale and biases while chunk c + 1's product runs
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
      // the register form's order: scale, key bias, then qbias (absent: + 0,
      // exact); rows past N take whatever their tile rows hold (they feed
      // only rows that are never stored); keys past N, in the last chunk
      // alone, are -inf
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

  // the exact row max over the quad, the exponentials and their sum (the
  // register form's order: chunk by chunk, then the quad)
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
  }
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
  // the exact divide v / sum as Markstein's correction of v * RN(1 / sum)
  const float rcp[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};

  // P V chunk by chunk: p (x amask / keep) in bf16 pairs as the register A
  // operand, v MN-major (its head columns contiguous), one commit group a
  // chunk and no wait until the last (each chunk keeps its own A registers)
  float o[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
  fence_acc(o);
  uint32_t a[NC][2][4];
  if (p.seed) mbar_wait(kwbar, 0);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int it = na + c, st = it % MID_STAGES;
    if (p.amask) mbar_wait(&full[st], (it / MID_STAGES) & 1);
    if (live_warp) {
      // the multipliers: the amask's (staged, each row shifted by sha), the
      // keep bits' (drawn by the producer) or 1; keys past N (their tiles
      // are not staged) 0
      float m[16];
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const bf16* ar =
              reinterpret_cast<const bf16*>(Ring + st * MID_STAGE + (r0 + 8 * hh) * AM_LD + sha[hh] + (cq + 8 * b) * 2);
          m[4 * b + 2 * hh] = p.amask ? __bfloat162float(ar[0]) : 1.f;
          m[4 * b + 2 * hh + 1] = p.amask ? __bfloat162float(ar[1]) : 1.f;
        }
      if (p.seed) {
        const uint32_t kw[2] = {Kw[c * LONG_ROWS + r0], Kw[c * LONG_ROWS + r0 + 8]};
#pragma unroll
        for (int x = 0; x < 16; ++x) m[x] = (kw[(x >> 1) & 1] >> (cq + (x >> 2) * 8 + (x & 1))) & 1u ? p.kept : 0.f;
      }
      if (c == NC - 1 && c * KEYS + KEYS > N) {
#pragma unroll
        for (int x = 0; x < 16; ++x)
          if (c * KEYS + cq + (x >> 2) * 8 + (x & 1) >= N) m[x] = 0.f;
      }
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float pv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * b + 2 * hh + e;
            const float q0 = s[c][x] * rcp[hh];
            pv[e] = fmaf(fmaf(-q0, sum[hh], s[c][x]), rcp[hh], q0) * m[x];
          }
          // x = 4 b + 2 hh .. + 1: k16 step b / 2, register 2 (b % 2) + hh
          a[c][b >> 1][2 * (b & 1) + hh] = pack_bf16(pv[0], pv[1]);
        }
    } else {
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16)
#pragma unroll
        for (int q = 0; q < 4; ++q) a[c][k16][q] = 0u;
    }
    if (p.amask) release_stage(&empty[st], lane);
    mbar_wait(&vbar[c], 0);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < 2; ++k16) {
      // 16 key rows; one column block, so LBO is unused (given SBO's value)
      const uint64_t dv = make_desc(v_base + c * KV + k16 * 16 * ROWB, SBO, SBO, SW);
      if constexpr (DP == 64)
        wgmma_m64n64k16_rs(o, a[c][k16], dv);
      else
        wgmma_m64n32k16_rs(o, a[c][k16], dv);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_acc(o);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int k16 = 0; k16 < 2; ++k16) fence_regs(a[c][k16]);

  // ctx through this warpgroup's q rows (its S products are done), then
  // 16-byte stores of the rows below N
  named_sync(1 + w, WARPGROUP);
#pragma unroll
  for (int b = 0; b < DP / 8; ++b) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(Qs + swz<ROWB>(r0 + 8 * hh, b) + cq * 2) =
          pack_bf16(o[4 * b + 2 * hh], o[4 * b + 2 * hh + 1]);
  }
  named_sync(1 + w, WARPGROUP);
  const long long out0 = g * p.out_g + h * p.out_h;
  const int chunks = p.Dh / 8;
  for (int e = tid; e < 64 * chunks; e += WARPGROUP) {
    const int r = w * 64 + e / chunks, cc = e % chunks;
    const int i = row0 + r;
    if (i < N)
      *reinterpret_cast<uint4*>(p.ctx + out0 + i * p.out_n + cc * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<ROWB>(r, cc));
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
cudaError_t launch_long(const void* q, const void* k, const void* v, int G, const Params& p, long long blocks,
                        cudaStream_t stream) {
  // q's, k's and v's maps: their bases and strides are the call's, so they are encoded at every launch
  CUtensorMap mq, mk, mv;
  if (!head_rows_map(&mq, q, p.Dh, p.nH, p.N, G, p.in_h, p.in_n, p.in_g, DP, LONG_KEYS) ||
      !head_rows_map(&mk, k, p.Dh, p.nH, p.N, G, p.in_h, p.in_n, p.in_g, DP, LONG_KEYS) ||
      !head_rows_map(&mv, v, p.Dh, p.nH, p.N, G, p.in_h, p.in_n, p.in_g, DP, LONG_KEYS))
    return cudaErrorInvalidValue;
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(attention_long_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         long_bytes(DP));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  attention_long_kernel<DP><<<static_cast<unsigned>(blocks), LONG_THREADS, long_bytes(DP), stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

template <int NC, int DP>
cudaError_t launch_mid(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, const Params& p,
                       long long blocks, int smem, cudaStream_t stream) {
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per instance (its largest N)
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(attention_mid_kernel<NC, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         mid_bytes(NC * KEYS, DP));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  attention_mid_kernel<NC, DP><<<static_cast<unsigned>(blocks), LONG_THREADS, smem, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

// the middle form at `chunks` key chunks (6-9)
template <int DP>
cudaError_t dispatch_mid(int chunks, const void* q, const void* k, const void* v, int G, const Params& p,
                         long long blocks, int smem, cudaStream_t stream) {
  // q's, k's and v's maps, in 32-row boxes, encoded at every launch as the long form's
  CUtensorMap mq, mk, mv;
  if (!head_rows_map(&mq, q, p.Dh, p.nH, p.N, G, p.in_h, p.in_n, p.in_g, DP, KEYS) ||
      !head_rows_map(&mk, k, p.Dh, p.nH, p.N, G, p.in_h, p.in_n, p.in_g, DP, KEYS) ||
      !head_rows_map(&mv, v, p.Dh, p.nH, p.N, G, p.in_h, p.in_n, p.in_g, DP, KEYS))
    return cudaErrorInvalidValue;
  switch (chunks) {
    case 6: return launch_mid<6, DP>(mq, mk, mv, p, blocks, smem, stream);
    case 7: return launch_mid<7, DP>(mq, mk, mv, p, blocks, smem, stream);
    case 8: return launch_mid<8, DP>(mq, mk, mv, p, blocks, smem, stream);
    case 9: return launch_mid<9, DP>(mq, mk, mv, p, blocks, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}
static_assert(MID_MIN_CHUNKS == 6 && MAX_CHUNKS == 9, "dispatch_mid covers every chunk count");

}  // namespace

// The shared memory a block may opt in to on the current device (-1 if the query failed).
extern "C" int mvlt_smem_optin(void) { return smem_optin(); }

// Shared memory one block of `form` (0 register, N <= 288; 1 middle, 161 <= N <= 288; 2 long, N <= 46,340)
// needs for (N, Dh), with or without an amask, or -1 where that form does not take them (or a head dim
// that is not 16, 32, 48 or 64); the long form's does not grow with N. The wrapper checks it against the
// card's opt-in limit.
extern "C" long long mvlt_attention_smem(int N, int Dh, int amask, int form) {
  return smem_bytes(N, Dh, amask != 0, form);
}

// q, k, v: bf16, element (g, h, n, d) at g * in_g + h * in_h + n * in_n + d; ctx: bf16, element
// (g, h, i, d) at g * out_g + h * out_h + i * out_n + d; all four 16-byte aligned, every stride a
// multiple of 8. pattern (P, nH, N, N) f32, kbias (G, N) f32, qbias (G, N, N) f32 and amask
// (G, nH, N, N) bf16 may each be null. seed: null, or (2,) int32 16-bit halves for mode (a), which
// keeps an element iff its Philox word < thresh and then multiplies by kept; amask must be null with
// it, and head0 + nH <= 256 (head0: the global index of head 0, which keys the draw). p_out (G, nH, N, N) bf16 (mode (b)) and mask_out (G, nH, N, N) f32 (mode (a)
// only) may be null. form: 0 the register form, 1 the middle form, 2 the long form (`mvlt_attention_smem`);
// in the middle and long forms pattern and p_out must be null.
extern "C" int mvlt_attention(const void* q, const void* k, const void* v, long long in_g, long long in_h,
                              long long in_n, void* ctx, long long out_g, long long out_h, long long out_n,
                              const void* pattern, const void* kbias, const void* qbias, const void* amask,
                              const void* seed, void* p_out, void* mask_out, int G, int N, int nH, int Dh,
                              int P, float scale, unsigned int thresh, float kept, int head0, int form,
                              void* stream) {
  const long long smem = smem_bytes(N, Dh, amask != nullptr, form);
  if (smem < 0 || G < 1 || nH < 1 || P < 1) return (int)cudaErrorInvalidValue;
  if (seed != nullptr && (amask != nullptr || head0 < 0 || head0 + nH > 256)) return (int)cudaErrorInvalidValue;
  if (mask_out != nullptr && seed == nullptr) return (int)cudaErrorInvalidValue;
  const bool long_form = form == FORM_LONG, staged = form != FORM_REGISTER;  // a TMA block of 128 rows
  if (staged && (pattern != nullptr || p_out != nullptr)) return (int)cudaErrorInvalidValue;
  // the middle form stages an amask's rows from the 16-byte boundary at or before each
  if (form == FORM_MIDDLE && ((uintptr_t)amask & 15)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)ctx) & 15) return (int)cudaErrorInvalidValue;
  if ((in_g | in_h | in_n | out_g | out_h | out_n) & 7) return (int)cudaErrorInvalidValue;
  const int optin = smem_optin();
  if (optin < 0 || smem > optin) return (int)cudaErrorInvalidValue;
  const int tiles = staged ? (N + LONG_ROWS - 1) / LONG_ROWS : (N + ROWS - 1) / ROWS;
  const long long blocks = (long long)G * nH * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the long form's bias-tile copies: the widest unit every row start allows
  const int qb_unit = stage_unit(qbias, N, 4), am_unit = stage_unit(amask, N, 2), kb_unit = stage_unit(kbias, N, 4);
  using cbf = const bf16*;
  const Params p{static_cast<cbf>(q), static_cast<cbf>(k), static_cast<cbf>(v), in_g, in_h, in_n,
                 out_g, out_h, out_n, static_cast<const float*>(pattern), static_cast<const float*>(kbias),
                 static_cast<const float*>(qbias), static_cast<cbf>(amask), static_cast<const int*>(seed),
                 static_cast<bf16*>(ctx), static_cast<bf16*>(p_out), static_cast<float*>(mask_out), N, nH,
                 Dh, P, tiles, !staged && amask != nullptr && mask_bytes(N, Dh) > 0, qb_unit, am_unit,
                 kb_unit, scale, thresh, kept, head0};
  const int chunks = (N + KEYS - 1) / KEYS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (long_form)
    return (int)(head_cols(Dh) == 64 ? launch_long<64>(q, k, v, G, p, blocks, s)
                                     : launch_long<32>(q, k, v, G, p, blocks, s));
  if (staged)
    return (int)(head_cols(Dh) == 64 ? dispatch_mid<64>(chunks, q, k, v, G, p, blocks, (int)smem, s)
                                     : dispatch_mid<32>(chunks, q, k, v, G, p, blocks, (int)smem, s));
  return (int)(head_cols(Dh) == 64 ? dispatch<64>(chunks, p, blocks, (int)smem, s)
                                   : dispatch<32>(chunks, p, blocks, (int)smem, s));
}
