// K2 `biased_attention`: for each (group g, head h)
//   ctx[g*N + i, h*Dh + d] = sum_j softmax_j((q_i * scale) . k_j + bias_ij) * v_jd
// read from fused QKV rows (rows = G*N, 3C) in bf16, for sm_90a.
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
// Two opt-in modes, neither with shared memory of its own:
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
// mvlt_tpu/ops/pallas_attn.py: `_attend` as called from `_full_body`
// (`_full_kernel`, `_full_shift_kernel`), `_block_kernel` and
// `_attn_ln_kernel`. It holds their exact (interpret-mode) math: scores in
// f32 from q scaled in f32, a max-subtracted softmax with an exact divide,
// probabilities rounded to bf16 before the PV product, PV accumulated in f32.
//
// Bound: tiny per block (N <= 162, Dh <= 64: at most ~7 MFLOP), so the cost is
// reading QKV (and the masks) once and writing ctx once. One block per
// (group, head) keeps the whole N x N score tile in shared memory and masks
// its own ragged edge, so the port needs neither the TPU's pad-to-8 rows nor
// its window-pair merge; qbias and amask are read from device memory where
// used, with no tile of their own. At Dh = 64 the tiles admit N <= 162 within
// the 232,448 bytes a block may opt in to (`smem_bytes` below; the wrapper in
// ops/kernels.py mirrors it). Scalar FMA from shared memory; tensor cores and
// several heads per block are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DH = 64;
constexpr size_t H100_SMEM_OPTIN = 232448;

// q (pre-scaled) and v: N x Dh f32; k: N x (Dh + 1); scores: N x (N + 1)
__host__ __device__ constexpr size_t smem_bytes(int N, int Dh) {
  return sizeof(float) * ((size_t)N * Dh * 2 + (size_t)N * (Dh + 1) + (size_t)N * (N + 1));
}
// the largest N at MAX_DH on an H100
constexpr int MAX_N = 162;
static_assert(smem_bytes(MAX_N, MAX_DH) <= H100_SMEM_OPTIN && smem_bytes(MAX_N + 1, MAX_DH) > H100_SMEM_OPTIN,
              "MAX_N follows smem_bytes");

__global__ void __launch_bounds__(THREADS)
attention_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ pattern,
                 const float* __restrict__ kbias, const float* __restrict__ qbias,
                 const __nv_bfloat16* __restrict__ amask, const int* __restrict__ seed, uint32_t thresh,
                 float kept, __nv_bfloat16* __restrict__ ctx, __nv_bfloat16* __restrict__ p_out,
                 float* __restrict__ mask_out, int N, int C, int Dh, int P, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int ldk = Dh + 1;  // odd row stride: threads on consecutive keys hit distinct banks
  const int lds = N + 1;
  float* Q = sm;                 // N x Dh, pre-scaled
  float* Kt = Q + N * Dh;        // N x ldk
  float* V = Kt + N * ldk;       // N x Dh
  float* S = V + N * Dh;         // N x lds

  const int h = blockIdx.x;
  const int g = blockIdx.y;
  const int nH = gridDim.x;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)g * N;
  const int ld = 3 * C;

  for (int e = tid; e < N * Dh; e += THREADS) {
    int n = e / Dh, d = e % Dh;
    const __nv_bfloat16* r = qkv + (row0 + n) * ld + h * Dh + d;
    Q[n * Dh + d] = __bfloat162float(r[0]) * scale;
    Kt[n * ldk + d] = __bfloat162float(r[C]);
    V[n * Dh + d] = __bfloat162float(r[2 * C]);
  }
  __syncthreads();

  const float* pb = pattern ? pattern + ((size_t)(g % P) * nH + h) * N * N : nullptr;
  const float* kb = kbias ? kbias + (size_t)g * N : nullptr;
  const float* qb = qbias ? qbias + (size_t)g * N * N : nullptr;
  for (int e = tid; e < N * N; e += THREADS) {
    int i = e / N, j = e % N;
    const float* q = Q + i * Dh;
    const float* k = Kt + j * ldk;
    float s = 0.f;
    for (int d = 0; d < Dh; ++d) s = fmaf(q[d], k[d], s);
    if (pb) s += pb[i * N + j];
    if (kb) s += kb[j];
    if (qb) s += qb[i * N + j];
    S[i * lds + j] = s;
  }
  __syncthreads();

  // one warp per row: max-subtracted softmax, exact divide, (b) the stored
  // p, the dropout mask in f32 (given, or (a) drawn), then p rounded to bf16
  const int lane = tid & 31;
  const size_t tile = ((size_t)g * nH + h) * N * N;
  const __nv_bfloat16* am = amask ? amask + tile : nullptr;
  __nv_bfloat16* po = p_out ? p_out + tile : nullptr;
  float* mo = mask_out ? mask_out + tile : nullptr;
  const uint32_t key = seed ? mvlt::adrop_key(seed) : 0u;
  for (int i = tid >> 5; i < N; i += THREADS / 32) {
    float* srow = S + i * lds;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, srow[j]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      float p = expf(srow[j] - mx);
      srow[j] = p;
      sum += p;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < N; j += 32) {
      float p = srow[j] / sum;
      if (po) po[i * N + j] = __float2bfloat16(p);
      if (am) p *= __bfloat162float(am[i * N + j]);
      if (seed) {
        const float m = mvlt::adrop_keep(key, g, h, (uint32_t)(i * N + j), thresh) ? kept : 0.f;
        if (mo) mo[i * N + j] = m;
        p *= m;
      }
      srow[j] = __bfloat162float(__float2bfloat16(p));
    }
  }
  __syncthreads();

  for (int e = tid; e < N * Dh; e += THREADS) {
    int i = e / Dh, d = e % Dh;
    const float* p = S + i * lds;
    float acc = 0.f;
    for (int j = 0; j < N; ++j) acc = fmaf(p[j], V[j * Dh + d], acc);
    ctx[(row0 + i) * C + h * Dh + d] = __float2bfloat16(acc);
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

}  // namespace

// The shared memory a block may opt in to on the current device (-1 if the query failed).
extern "C" int mvlt_smem_optin(void) { return smem_optin(); }

// Shared memory one block needs for (N, Dh); the wrapper checks it against the card's opt-in limit.
extern "C" long long mvlt_attention_smem(int N, int Dh) { return (long long)smem_bytes(N, Dh); }

// pattern (P, nH, N, N) f32, kbias (G, N) f32, qbias (G, N, N) f32 and amask (G, nH, N, N) bf16 may
// each be null. seed: null, or (2,) int32 16-bit halves for mode (a), which keeps an element iff its
// Philox word < thresh and then multiplies by kept; amask must be null with it, and nH <= 256.
// p_out (G, nH, N, N) bf16 (mode (b)) and mask_out (G, nH, N, N) f32 (mode (a) only) may be null.
extern "C" int mvlt_attention(const void* qkv, const void* pattern, const void* kbias, const void* qbias,
                              const void* amask, const void* seed, void* ctx, void* p_out, void* mask_out,
                              int G, int N, int C, int nH, int P, float scale, unsigned int thresh,
                              float kept, void* stream) {
  if (N < 1 || nH < 1 || C % nH != 0 || C / nH > MAX_DH) return (int)cudaErrorInvalidValue;
  if (seed != nullptr && (amask != nullptr || nH > 256)) return (int)cudaErrorInvalidValue;
  if (mask_out != nullptr && seed == nullptr) return (int)cudaErrorInvalidValue;
  const int Dh = C / nH;
  const size_t smem = smem_bytes(N, Dh);
  const int optin = smem_optin();
  if (optin < 0 || smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  static size_t attr_bytes = 0;  // above 48 KB needs the opt-in
  if (smem > attr_bytes) {
    cudaError_t e = cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = smem;
  }
  dim3 grid(nH, G);
  attention_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(pattern),
      static_cast<const float*>(kbias), static_cast<const float*>(qbias),
      static_cast<const __nv_bfloat16*>(amask), static_cast<const int*>(seed), thresh, kept,
      static_cast<__nv_bfloat16*>(ctx), static_cast<__nv_bfloat16*>(p_out), static_cast<float*>(mask_out), N, C,
      Dh, P, scale);
  return (int)cudaGetLastError();
}
