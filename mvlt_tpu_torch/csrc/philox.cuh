// Philox4x32-10 (Salmon, Moraes, Dror and Shaw, "Parallel random numbers: as
// easy as 1, 2, 3", SC 2011), written out as a __device__ function, and the
// attention-dropout keep test that K2 and K4 draw from it.
//
// Replaces the TPU's in-kernel PRNG of `_adrop_mask`
// (mvlt_tpu/ops/pallas_attn.py:2133), which seeds `pltpu.prng_seed` with
// (hi * 65536 + lo, sample * 256 + head) and draws an (N, N) block of bits.
// The port keeps that seeding and defines its own stream (the TPU's bits
// cannot be reproduced off the TPU):
//   key     = (hi * 65536 + lo, 0)           the step's two 16-bit seed halves
//   counter = (e / 4, b * 256 + h, 0, 0)     e = i * N + j, b the ABSOLUTE sample
//   word    = e % 4 of the four outputs
// and keeps element (b, h, i, j) iff word < T, T = min(keep * 2^32, 2^32 - 1),
// as `_adrop_mask` keeps bits < thresh. The word depends only on the seed, b,
// h, i, j and N, never on the grid, block or tile, so K2's draw, K4's
// regeneration and the plain PyTorch version (`adrop_mask_plain` in
// ops/kernels.py) give bit-identical masks. Each element runs its own 10
// rounds (4 words drawn, 1 used): at N = 131 that is ~60 integer
// instructions per score, far below the kernels' f32 work per score.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mvlt {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;  // round multipliers
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;  // key increments (Weyl)
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += W0;
    k.y += W1;
  }
  return c;
}

// the Philox key word of a (2,) int32 seed of two 16-bit halves
__device__ __forceinline__ uint32_t adrop_key(const int* seed) {
  return (uint32_t)seed[0] * 65536u + (uint32_t)seed[1];
}

// whether element e = i * N + j of (sample b, head h) is kept
__device__ __forceinline__ bool adrop_keep(uint32_t key, int b, int h, uint32_t e, uint32_t thresh) {
  const uint4 r = philox4x32_10(make_uint4(e >> 2, (uint32_t)b * 256u + (uint32_t)h, 0u, 0u),
                                make_uint2(key, 0u));
  const uint32_t s = e & 3u;
  const uint32_t w = s == 0 ? r.x : (s == 1 ? r.y : (s == 2 ? r.z : r.w));
  return w < thresh;
}

}  // namespace mvlt
