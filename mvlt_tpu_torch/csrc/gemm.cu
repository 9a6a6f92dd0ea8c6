// K1 `gemm`: Y[sidx[m]] = epilogue(op(A) . op(B) + b) in bf16 operands with an
// f32 accumulator, for sm_90a.
//
// Replaces the matrix products inside the TPU kernels of
// mvlt_tpu/ops/pallas_attn.py: forward (`_full_body` :571 qkv / proj / fc1 /
// fc2, `_block_kernel`, `_attn_ln_kernel`, `_mlp_ln_kernel`,
// `_mlp_preln_kernel`, `_swin_tail_kernel`) and backward (`_swin_mlp_bwd_kernel`
// :1618 with its dW1 / dW2 sums carried across the sequential grid at
// :1689-1695, `_swin_qkv_tail_kernel` :1787, `_mlp_ln_bwd_kernel` :2931: the
// fc1 recompute, dW2, dm, dW1 and dx products, and the XLA products around
// `_seq_core_bwd_kernel`).
//
// Layouts (all row-major in memory):
//   NT  A (M, K), B (N, K): Y = A B^T   the PyTorch Linear layout (forward)
//   NN  A (M, K), B (K, N): Y = A B     dX = dY W
//   TN  A (K, M), B (K, N): Y = A^T B   dW = dY^T X, contraction over rows
//
// Epilogue, in f32 before the one rounding of the output:
//   + bias[n]                           (optional, bf16)
//   store the pre-activation to P[m, n] (optional, f32; the fc1 recompute)
//   exact erf GELU                      (epi 1)
//   * gelu'(P[m, n])                    (epi 2; P is an f32 input, dA1 = dM * gelu'(a1))
//   * E[m, n]                           (optional bf16 multiplier: the hidden-dropout
//                                        mask, `attn * hmask` at pallas_attn.py:2241-2243
//                                        and the fc2 output of `_mlp_ln_kernel` :2836)
//   * S[m / s_div]                      (optional f32 row scale: the Swin DropPath
//                                        multipliers, `attn * dp1` and `mlp * dp2` in
//                                        `_full_body` :630,647 and `_swin_tail_kernel`
//                                        :3485,3492; s_div rows share one value, so a
//                                        per-image scale needs no per-row copy)
//   + R[ridx ? ridx[m] : m, n]          (optional residual, bf16 or f32, optional row gather)
//   store to row sidx ? sidx[m] : m     (optional row scatter), bf16 or f32
//
// Bound: at the Swin-S b32 shapes the stage-1 and stage-2 products (K or N of
// 96-384 against 100,352 / 25,088 rows, about 200 flop per byte) are bound by
// bytes; the rest (C >= 384, BERT's 768 / 3072) by the tensor cores' operations.
// The design serves both with Hopper's own data path:
//   - a 4-stage ring of 128 x 64 bf16 tiles of A and B in shared memory with the
//     128-byte swizzle (64 bf16 are one swizzle row), filled by TMA
//     (`cp.async.bulk.tensor.2d`) from one producer thread against `full` /
//     `empty` mbarriers: no thread spends registers or instructions on
//     addresses, and out-of-bounds rows and columns arrive as zeros;
//   - two consumer warpgroups, each issuing `wgmma.m64n128k16` on its 64 rows
//     of the 128 x 128 output tile straight from shared memory, f32
//     accumulators in registers (`setmaxnreg` moves registers from the producer
//     warpgroup to them). The three layouts share this mainloop: an operand
//     whose contraction dim is not the contiguous one (A in TN, B in NN and TN)
//     is loaded as two 64-wide column blocks and read MN-major through
//     `wgmma`'s transpose bit;
//   - a deterministic split-K for products whose 128 x 128 tiles fill less than
//     half the card and whose contraction is long (the weight gradients dW =
//     dY^T X at Swin stages 1-3: a C x 4C output over 100,352 rows would run on
//     a handful of SMs). The grid's z index takes a contiguous run of k-tiles,
//     writes its f32 partial tile to a workspace, and a second kernel sums the
//     slices in slice order: no atomics, so two calls agree bitwise. The plan
//     (how many slices) is made by the caller (`ops/kernels.py:gemm_plan`); a
//     split product has no epilogue.
//   - one persistent block per SM walks the output tiles, so the producer
//     loads the next tile while the consumers run this one's epilogue.
// The epilogue is bound by bytes wherever it reads or writes f32 (M, N)
// tensors, so each warpgroup first stages its f32 tile in shared memory and
// then every thread moves 16-32 contiguous bytes of P, E, R and the output
// (the row scatter rules out a tiled TMA store). The contiguous dims of both
// operands must be multiples of 8 (16-byte TMA strides; checked by the
// caller); the contraction and the row counts may have any length.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, the wgmma descriptor and products

namespace {

using namespace mvlt;

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 4;
constexpr int THREADS = 384;  // warpgroup 0 produces, warpgroups 1-2 consume
constexpr int TILE_BYTES = BM * BK * 2;  // one operand's stage: 16 KB
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int HALF_BYTES = 64 * 128;  // 64 rows (or k-rows) of 128 bytes
constexpr int OUT_LD = BN + 8;  // padded f32 row of a warpgroup's staged output
constexpr int OUT_BYTES = 64 * OUT_LD * 4;
// the ring, the two warpgroups' output staging, slack for 1024-byte alignment
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * OUT_BYTES + 1024;

enum Layout { NT = 0, NN = 1, TN = 2 };
enum Epi { EPI_NONE = 0, EPI_GELU = 1, EPI_GELU_GRAD = 2 };
constexpr int OUT_F32 = 1, RES_F32 = 2;

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// d/da of a * Phi(a): Phi(a) + a * phi(a)   (`_gelu_grad`, exact path)
__device__ __forceinline__ float gelu_erf_grad(float a) {
  float Phi = 0.5f * (1.0f + erff(a * 0.70710678118654752f));
  float phi = expf(-0.5f * a * a) * 0.3989422804014327f;
  return Phi + a * phi;
}

struct Args {
  const __nv_bfloat16* bias;
  const void* R;
  const int* ridx;
  const int* sidx;
  void* Y;
  float* P;  // pre-activation: written (epi 0/1) or read (epi 2)
  const __nv_bfloat16* E;  // epilogue multiplier (M, N), row m unscattered
  const float* S;          // row scale, row m reads S[m / s_div]
  float* ws;               // split-K partials (splits, M, N), or null
  int M, N, K, epi, flags, s_div, splits;
};

// 8 consecutive bf16 / f32 values <-> f32 registers (16- / 32-byte accesses)
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0], b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = raw;
}

__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// The epilogue of one consumer warpgroup's 64 x 128 share of a tile (rows
// m_base.., columns n0..). The accumulators go through shared memory
// (`stage`, padded rows: the fragment's column pairs and the row reads are
// both free of bank conflicts), so that each thread then owns 8 consecutive
// columns of 8 rows and every global access (P, E, R, the output) is 16 or 32
// contiguous bytes. A split-K slice stores its f32 partial to its plane of the
// workspace instead.
__device__ __forceinline__ void epilogue(const Args& p, const float (&acc)[64], float* stage,
                                         int m_base, int n0, int z, int bar_id) {
  const int M = p.M, N = p.N;
  const int t = threadIdx.x & 127, lane = t & 31, warp = t >> 5;
  wg_barrier(bar_id);  // the last tile's reads of `stage` are done
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* row = stage + (warp * 16 + (lane >> 2) + h * 8) * OUT_LD + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(row + j * 8) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  wg_barrier(bar_id);
  const int q = t & 15;
  const int n = n0 + q * 8;
  if (n >= N) return;
  const bool out_f32 = p.flags & OUT_F32;
  const bool res_f32 = p.flags & RES_F32;
  float b[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (p.bias) load8(p.bias + n, b);
#pragma unroll 2
  for (int i = 0; i < 8; ++i) {
    const int r = (t >> 4) + i * 8;
    const int m = m_base + r;
    if (m >= M) continue;
    float v[8];
    load8(stage + r * OUT_LD + q * 8, v);
    const size_t mi = static_cast<size_t>(m) * N + n;
    if (p.splits > 1) {
      store8(p.ws + static_cast<size_t>(z) * M * N + mi, v);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += b[e];
    if (p.epi == EPI_GELU_GRAD) {
      float a1[8];
      load8(p.P + mi, a1);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= gelu_erf_grad(a1[e]);
    } else if (p.P) {
      store8(p.P + mi, v);
    }
    if (p.epi == EPI_GELU) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = gelu_erf(v[e]);
    }
    if (p.E) {
      float ev[8];
      load8(p.E + mi, ev);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= ev[e];
    }
    if (p.S) {
      const float rs = p.S[m / p.s_div];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= rs;
    }
    if (p.R) {
      const size_t ri = static_cast<size_t>(p.ridx ? p.ridx[m] : m) * N + n;
      float rv[8];
      if (res_f32)
        load8(static_cast<const float*>(p.R) + ri, rv);
      else
        load8(static_cast<const __nv_bfloat16*>(p.R) + ri, rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += rv[e];
    }
    const size_t oi = static_cast<size_t>(p.sidx ? p.sidx[m] : m) * N + n;
    if (out_f32)
      store8(static_cast<float*>(p.Y) + oi, v);
    else
      store8(static_cast<__nv_bfloat16*>(p.Y) + oi, v);
  }
}

// ---- the kernel ------------------------------------------------------------

template <int LAYOUT>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b, Args p) {
  constexpr bool A_MN = LAYOUT == TN;                 // A tile stored [k][m]
  constexpr bool B_MN = LAYOUT == NN || LAYOUT == TN;  // B tile stored [k][n]

  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int M = p.M, N = p.N;
  const int tiles_n = (N + BN - 1) / BN, tiles_m = (M + BM - 1) / BM;
  const int items = tiles_n * tiles_m * p.splits;
  const int ktiles = (p.K + BK - 1) / BK;
  // work item -> (slice z, tile row, tile column); a slice is a balanced run
  // of whole k-tiles, in order
  auto decode = [&](int item, int& m0, int& n0, int& z, int& kt0, int& nk) {
    n0 = (item % tiles_n) * BN;
    const int rest = item / tiles_n;
    m0 = (rest % tiles_m) * BM;
    z = rest / tiles_m;
    kt0 = static_cast<int>((static_cast<long long>(z) * ktiles) / p.splits);
    nk = static_cast<int>((static_cast<long long>(z + 1) * ktiles) / p.splits) - kt0;
  };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 1);  // the producer's arrive + the TMA bytes
      mbar_init(&empty_bar[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // persistent: block b takes work items b, b + gridDim.x, ...; the ring
  // position `it` runs on across items, so the producer loads the next
  // item's tiles while the consumers store this one's
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int m0, n0, z, kt0, nk;
        decode(item, m0, n0, z, kt0, nk);
        // an MN-major column block wholly past the edge is not loaded: it
        // feeds only output rows (columns) that are never stored
        const bool a_hi = !A_MN || m0 + 64 < M, b_hi = !B_MN || n0 + 64 < N;
        const uint32_t bytes = (a_hi ? TILE_BYTES : HALF_BYTES) + (b_hi ? TILE_BYTES : HALF_BYTES);
        for (int i = 0; i < nk; ++i, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty_bar[s], ((it / STAGES) - 1) & 1);
          unsigned char* a_s = smem + s * STAGE_BYTES;
          unsigned char* b_s = a_s + TILE_BYTES;
          const int k0 = (kt0 + i) * BK;
          mbar_expect_tx(&full_bar[s], bytes);
          if (A_MN) {  // A (K, M): boxes of 64 m x 64 k
            tma_load(a_s, &map_a, &full_bar[s], m0, k0);
            if (a_hi) tma_load(a_s + HALF_BYTES, &map_a, &full_bar[s], m0 + 64, k0);
          } else {  // A (M, K): one box of 64 k x 128 m
            tma_load(a_s, &map_a, &full_bar[s], k0, m0);
          }
          if (B_MN) {  // B (K, N): boxes of 64 n x 64 k
            tma_load(b_s, &map_b, &full_bar[s], n0, k0);
            if (b_hi) tma_load(b_s + HALF_BYTES, &map_b, &full_bar[s], n0 + 64, k0);
          } else {  // B (N, K): one box of 64 k x 128 n
            tma_load(b_s, &map_b, &full_bar[s], k0, n0);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 64c .. 64c + 63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int lane = tid & 31;
  float* out_stage = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES + c * OUT_BYTES);
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int m0, n0, z, kt0, nk;
    decode(item, m0, n0, z, kt0, nk);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_acc(acc);
    for (int i = 0; i < nk; ++i, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full_bar[s], (it / STAGES) & 1);
      // K-major rows 64c.. and MN-major column block c both start 8 KB in
      const uint32_t a_base = smem_u32(smem + s * STAGE_BYTES) + c * HALF_BYTES;
      const uint32_t b_base = smem_u32(smem + s * STAGE_BYTES + TILE_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // a k16 step: 32 bytes along a K-major row, 16 k-rows (2 KB) of an MN-major tile
        const uint64_t da = make_desc(a_base + (A_MN ? kk * 2048 : kk * 32), A_MN ? HALF_BYTES : 16, 1024);
        const uint64_t db = make_desc(b_base + (B_MN ? kk * 2048 : kk * 32), B_MN ? HALF_BYTES : 16, 1024);
        wgmma_m64n128k16<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
      }
      wgmma_commit();
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      fence_acc(acc);
      if (i > 0 && lane == 0) mbar_arrive(&empty_bar[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (nk > 0 && lane == 0) mbar_arrive(&empty_bar[(it - 1) % STAGES]);
    epilogue(p, acc, out_stage, m0 + c * 64, n0, z, 1 + c);
  }
}

// Y = sum over the slices of the partials, in slice order (four values a thread)
__global__ void gemm_fold_kernel(const float* __restrict__ ws, void* Y, long long mn, int splits,
                                 int out_f32) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x * 4;
  for (long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4; i < mn;
       i += stride) {
    float4 s = *reinterpret_cast<const float4*>(ws + i);
    for (int z = 1; z < splits; ++z) {
      const float4 t = *reinterpret_cast<const float4*>(ws + z * mn + i);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    if (out_f32) {
      *reinterpret_cast<float4*>(static_cast<float*>(Y) + i) = s;
    } else {
      __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(Y) + i);
      y[0] = __floats2bfloat162_rn(s.x, s.y);
      y[1] = __floats2bfloat162_rn(s.z, s.w);
    }
  }
}

// ---- host side -------------------------------------------------------------

// a bf16 row-major (rows, cols) matrix, read in boxes of box_rows x 64 columns
// with the 128-byte swizzle; out-of-bounds elements read as zero
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  cuuint32_t estr[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
                estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// streaming multiprocessors of the current device (cached per device)
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

template <int LAYOUT>
cudaError_t launch(const void* A, const void* B, const Args& p, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  const bool ok_a = LAYOUT == TN ? make_map(&map_a, A, p.K, p.M, 64) : make_map(&map_a, A, p.M, p.K, BM);
  const bool ok_b = LAYOUT == NT ? make_map(&map_b, B, p.N, p.K, BN) : make_map(&map_b, B, p.K, p.N, 64);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(gemm_wgmma_kernel<LAYOUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const long long items = static_cast<long long>((p.N + BN - 1) / BN) * ((p.M + BM - 1) / BM) * p.splits;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < sms ? items : sms);  // one persistent block per SM
  gemm_wgmma_kernel<LAYOUT><<<grid, THREADS, SMEM_BYTES, stream>>>(map_a, map_b, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const long long mn = static_cast<long long>(p.M) * p.N;
  const long long blocks = (mn / 4 + 255) / 256;
  gemm_fold_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      p.ws, p.Y, mn, p.splits, p.flags & OUT_F32);
  return cudaGetLastError();
}

}  // namespace

// layout: 0 NT, 1 NN, 2 TN; epi: 0 none, 1 GELU, 2 GELU'; flags: 1 f32 output, 2 f32 residual.
// P: f32 (M, N) pre-activation, written when given with epi 0/1, read with epi 2.
// E: bf16 (M, N) multiplier applied before the residual add, or null.
// S: f32 row scale applied after E, row m reads S[m / s_div], or null.
// splits > 1: the contraction in that many slices of whole k-tiles, f32
// partials in ws (splits, M, N), folded in order; only with no epilogue.
extern "C" int mvlt_gemm(const void* A, const void* B, const void* bias, const void* R, const void* ridx,
                         const void* sidx, void* Y, void* P, const void* E, const void* S, int M, int N, int K,
                         int layout, int epi, int flags, int s_div, void* ws, int splits, void* stream) {
  Args p{static_cast<const __nv_bfloat16*>(bias), R, static_cast<const int*>(ridx),
         static_cast<const int*>(sidx), Y, static_cast<float*>(P), static_cast<const __nv_bfloat16*>(E),
         static_cast<const float*>(S), static_cast<float*>(ws), M, N, K, epi, flags, s_div, splits};
  if (M < 1 || N < 1 || K < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  if (epi == EPI_GELU_GRAD && P == nullptr) return (int)cudaErrorInvalidValue;
  if (S != nullptr && s_div < 1) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (ws == nullptr || bias || R || sidx || P || E || S || epi != EPI_NONE ||
                     splits > (K + BK - 1) / BK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case NT: return (int)launch<NT>(A, B, p, s);
    case NN: return (int)launch<NN>(A, B, p, s);
    case TN: return (int)launch<TN>(A, B, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
