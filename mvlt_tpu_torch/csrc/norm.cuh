// The row plan and the 16-byte row access that K3 (layernorm.cu) and K5
// (layernorm_bwd.cu) share, for sm_90a.
//
// A row of C channels is cut into chunks of 8 elements: 16 bytes of bf16,
// two 16-byte words of f32. A group of `lanes` lanes of a warp (a power of
// two, at most 32) owns one row, each lane `chunks` chunks: lane l of the
// group holds chunks j * lanes + l, so for each j the group reads one
// contiguous run of 16-byte words. A warp holds 32 / lanes rows at once and
// a block of NORM_WARPS warps `rows_per_block`. row_plan takes the (lanes,
// chunks) that leaves the fewest chunk slots idle, and of those the fewest
// chunks a lane: C = 96 is 4 lanes x 3 chunks (8 rows a warp), 192 is 8 x 3,
// 384 16 x 3, 768 32 x 3, 1024 32 x 4. Above 1024 (K3 only) a row takes
// the warp, ceil(C / 256) chunks a lane. Where C % 8 != 0 the rows are not
// 16-byte aligned and each chunk is read and written element by element
// (`vec` false); the base pointers are 16-byte aligned (the wrappers check).
// mvlt_tpu_torch/ops/kernels.py mirrors the plan (`row_plan`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mvlt {

constexpr int NORM_WARPS = 4;  // warps a block of the row kernels
constexpr int NORM_VEC = 8;    // elements a chunk

struct RowPlan {
  int lanes, chunks, rows_per_block, vec;  // lanes == 0: C not taken
};

// the plan of a row of C channels, C in 1 .. max_c (K5: 1024, K3: 2048)
inline RowPlan row_plan(int C, int max_c) {
  RowPlan best{0, 0, 0, 0};
  if (C < 1 || C > max_c) return best;
  const int n = (C + NORM_VEC - 1) / NORM_VEC;
  if (n > 4 * 32) return RowPlan{32, (n + 31) / 32, NORM_WARPS, C % NORM_VEC == 0};
  int waste = 1 << 30;
  for (int j = 1; j <= 4; ++j) {
    int g = 1;
    while (g < (n + j - 1) / j) g <<= 1;
    if (g <= 32 && g * j - n < waste) {
      waste = g * j - n;
      best = RowPlan{g, j, NORM_WARPS * (32 / g), C % NORM_VEC == 0};
    }
  }
  return best;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// the chunk of 8 elements at `off` of a bf16 (f32 false) or f32 array; on
// the element path those at or past `valid` read as 0
__device__ __forceinline__ void load8(const void* p, size_t off, bool f32, bool vec, int valid,
                                      float (&v)[8]) {
  if (vec) {
    if (f32) {
      const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + off);
      float4 a = __ldg(q), b = __ldg(q + 1);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
      unpack8(__ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p) + off)), v);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    v[e] = 0.f;
    if (e < valid)
      v[e] = f32 ? static_cast<const float*>(p)[off + e]
                 : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[off + e]);
  }
}

__device__ __forceinline__ void store8(float* p, size_t off, bool vec, int valid, const float (&v)[8]) {
  if (vec) {
    float4* q = reinterpret_cast<float4*>(p + off);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < valid) p[off + e] = v[e];
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, size_t off, bool vec, int valid, const float (&v)[8]) {
  if (vec) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p + off) = u;
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < valid) p[off + e] = __float2bfloat16(v[e]);
}

// sum of v over the `lanes` lanes of a row group (a power of two), the
// same tree in every group
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace mvlt
