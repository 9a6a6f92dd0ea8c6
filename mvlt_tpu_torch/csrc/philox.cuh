// Philox4x32-10 (Salmon, Moraes, Dror and Shaw, "Parallel random numbers: as
// easy as 1, 2, 3", SC 2011), written out as a __device__ function, and the
// attention-dropout draw (`draw_chunk`) that K2 and K4 take from it.
//
// Replaces the TPU's in-kernel PRNG of `_adrop_mask`
// (mvlt_tpu/ops/pallas_attn.py:2133), which seeds `pltpu.prng_seed` with
// (hi * 65536 + lo, sample * 256 + head) and draws an (N, N) block of bits.
// The port keeps that seeding and defines its own stream (the TPU's bits
// cannot be reproduced off the TPU):
//   key     = (hi * 65536 + lo, 0)           the step's two 16-bit seed halves
//   counter = (e / 4, b * 256 + h, 0, 0)     e = i * N + j, b the ABSOLUTE sample,
//                                            h the GLOBAL head (a launch's head0 + its own)
//   word    = e % 4 of the four outputs
// and keeps element (b, h, i, j) iff word < T, T = min(keep * 2^32, 2^32 - 1),
// as `_adrop_mask` keeps bits < thresh. The word depends only on the seed, b,
// h, i, j and N, never on the grid, block or tile, so K2's draw, K4's
// regeneration and the plain PyTorch version (`adrop_mask_plain` in
// ops/kernels.py) give bit-identical masks. The register forms of K2 and
// K4's first pass share each Philox call between two scores of a row
// (`draw_chunk` below); the long forms' producers draw a row's keep word of
// a 32-key chunk (`keep_word`), the middle forms' two chunks' at once
// (`keep_word2`); K4's second pass reads the keep bits that its first pass
// drew.

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

// For one 32-key chunk of a thread's scores (accumulator layout, hopper.cuh): bit x set keeps element x
// (row erow / N, column c0 + cq + col(x)). The four lanes of a row quad
// cover 8 consecutive columns, i.e. words E0 .. E0 + 7 of the stream (E0 =
// i * N + the quad's first column): lane q runs Philox on block E0 / 4 + q
// and each lane takes its two words from the lanes that hold them, one
// Philox call for two scores. Every lane of the warp takes part (the
// shuffles); out-of-range elements are not kept and not written to mo.
__device__ __noinline__ uint32_t draw_chunk(int c0, int erow0, int erow1, bool live0, bool live1, int cq,
                                            int lane, int N, uint32_t key, uint32_t ctr1, uint32_t thresh,
                                            float kept, float* mo) {
  uint32_t keep = 0;
#pragma unroll 1
  for (int t = 0; t < 8; ++t) {
    const int bb = t >> 1, hh = t & 1;
    const int erow = hh ? erow1 : erow0, E0 = erow + c0 + 8 * bb;
    const uint4 r = philox4x32_10(make_uint4((uint32_t)(E0 >> 2) + (lane & 3), ctr1, 0u, 0u),
                                  make_uint2(key, 0u));
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int m = (E0 & 3) + cq + k, src = (lane & ~3) | (m >> 2);
      const uint32_t w0 = __shfl_sync(0xffffffffu, r.x, src), w1 = __shfl_sync(0xffffffffu, r.y, src);
      const uint32_t w2 = __shfl_sync(0xffffffffu, r.z, src), w3 = __shfl_sync(0xffffffffu, r.w, src);
      const uint32_t w = (m & 3) == 0 ? w0 : (m & 3) == 1 ? w1 : (m & 3) == 2 ? w2 : w3;
      const int j = c0 + 8 * bb + cq + k;
      if ((hh ? live1 : live0) && j < N) {
        keep |= (uint32_t)(w < thresh) << (4 * bb + 2 * hh + k);
        if (mo) mo[erow + j] = w < thresh ? kept : 0.f;
      }
    }
  }
  return keep;
}

// The keep word of row i over the keys key0 .. key0 + 31: bit j keeps
// element (i, key0 + j), for key0 + j < N (i * N + key0 < 2^31), from the
// Philox blocks that cover those words (8 or 9 calls).
__device__ __forceinline__ uint32_t keep_word(int i, int key0, int N, uint32_t key, uint32_t ctr1,
                                              uint32_t thresh) {
  const int e0 = i * N + key0, jn = N - key0 < 32 ? N - key0 : 32;
  uint32_t wd = 0;
#pragma unroll 1
  for (int b = e0 >> 2; b <= (e0 + jn - 1) >> 2; ++b) {
    const uint4 r = philox4x32_10(make_uint4((uint32_t)b, ctr1, 0u, 0u), make_uint2(key, 0u));
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * b + k - e0;
      if (j >= 0 && j < jn && w[k] < thresh) wd |= 1u << j;
    }
  }
  return wd;
}

// keep_word of row i for two chunks at once (keys key0a .. and key0b ..),
// their Philox calls interleaved (two independent chains a step): the same
// two words as two keep_word calls
__device__ __forceinline__ void keep_word2(int i, int key0a, int key0b, int N, uint32_t key, uint32_t ctr1,
                                           uint32_t thresh, uint32_t& wa, uint32_t& wb) {
  const int ea = i * N + key0a, ja = N - key0a < 32 ? N - key0a : 32;
  const int eb = i * N + key0b, jb = N - key0b < 32 ? N - key0b : 32;
  const int ba = ea >> 2, na = ((ea + ja - 1) >> 2) - ba + 1, bb = eb >> 2, nb = ((eb + jb - 1) >> 2) - bb + 1;
  wa = wb = 0;
#pragma unroll 1
  for (int k = 0; k < (na > nb ? na : nb); ++k) {
    const uint4 ra = philox4x32_10(make_uint4((uint32_t)(ba + k), ctr1, 0u, 0u), make_uint2(key, 0u));
    const uint4 rb = philox4x32_10(make_uint4((uint32_t)(bb + k), ctr1, 0u, 0u), make_uint2(key, 0u));
    const uint32_t xa[4] = {ra.x, ra.y, ra.z, ra.w}, xb[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * (ba + k) + q - ea, l = 4 * (bb + k) + q - eb;
      if (k < na && j >= 0 && j < ja && xa[q] < thresh) wa |= 1u << j;
      if (k < nb && l >= 0 && l < jb && xb[q] < thresh) wb |= 1u << l;
    }
  }
}

}  // namespace mvlt
