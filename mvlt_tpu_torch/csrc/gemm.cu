// K1 `gemm`: Y[sidx[m]] = epilogue(op(A) . op(B) + b) in bf16 operands with an
// f32 accumulator, for sm_90a.
//
// Replaces the matrix products inside the TPU kernels of
// mvlt_tpu/ops/pallas_attn.py: forward (`_full_body` qkv / proj / fc1 / fc2,
// `_block_kernel`, `_attn_ln_kernel`, `_mlp_ln_kernel`, `_mlp_preln_kernel`)
// and backward (the fc1 recompute, dW2, dm, dW1 and dx products of
// `_mlp_ln_bwd_kernel`, and the XLA products around `_seq_core_bwd_kernel`).
//
// Layouts (all row-major in memory):
//   NT  A (M, K), B (N, K): Y = A B^T   the PyTorch Linear layout (forward)
//   NN  A (M, K), B (K, N): Y = A B     dX = dY W
//   TN  A (K, M), B (K, N): Y = A^T B   dW = dY^T X, contraction over rows
// Tiles whose contraction dim is not the contiguous one are read with
// `ldmatrix.trans`, so all three feed the same `mma.sync.m16n8k16.row.col`.
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
// Bound: at the shapes of the port (K, N <= 3072, M up to 25088, and the
// weight-gradient products' contraction over M = 2368 rows) these products are
// compute-bound in principle (up to ~1000 flop per byte). This version is a
// plain tiled tensor-core GEMM: a 3-stage cp.async ring of 32-deep tiles in
// padded shared memory, 8 warps each owning a 32 x (BN / warps_n) sub-tile.
// No wgmma/TMA yet: that is later work. Ragged edges are masked at 16-byte
// granularity: the contiguous dims of both operands must be multiples of 8
// (checked by the caller); a contraction over rows (TN, NN's B) is masked
// per row and may have any length.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int LDS = BK + 8;  // padded K-contiguous smem row: 80 bytes, conflict-free ldmatrix
constexpr int THREADS = 256;

enum Layout { NT = 0, NN = 1, TN = 2 };
enum Epi { EPI_NONE = 0, EPI_GELU = 1, EPI_GELU_GRAD = 2 };
constexpr int OUT_F32 = 1, RES_F32 = 2;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3,
                                            const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_t(unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3,
                                              const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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
  const __nv_bfloat16* A;
  const __nv_bfloat16* B;
  const __nv_bfloat16* bias;
  const void* R;
  const int* ridx;
  const int* sidx;
  void* Y;
  float* P;  // pre-activation: written (epi 0/1) or read (epi 2)
  const __nv_bfloat16* E;  // epilogue multiplier (M, N), row m unscattered
  const float* S;          // row scale, row m reads S[m / s_div]
  int M, N, K, epi, flags, s_div;
};

// smem elements of one stage of each operand
template <int BM, bool AT>
__host__ __device__ constexpr int a_stage() { return AT ? BK * (BM + 8) : BM * LDS; }
template <bool BT>
__host__ __device__ constexpr int b_stage() { return BT ? BK * (BN + 8) : BN * LDS; }

template <int BM, int LAYOUT>
__global__ void __launch_bounds__(THREADS) gemm_kernel(Args p) {
  constexpr bool AT = LAYOUT == TN;              // A tile stored [k][m]
  constexpr bool BT = LAYOUT == NN || LAYOUT == TN;  // B tile stored [k][n]
  constexpr int WARPS_M = BM / 32;
  constexpr int WARPS_N = (THREADS / 32) / WARPS_M;
  constexpr int WN = BN / WARPS_N;  // columns per warp
  constexpr int NT_ = WN / 8;       // n8 tiles per warp
  constexpr int LDA_T = BM + 8;     // padded row of a [k][m] tile
  constexpr int LDB_T = BN + 8;
  static_assert(NT_ % 2 == 0, "ldmatrix.x4 loads two n8 tiles at a time");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + STAGES * a_stage<BM, AT>();

  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % WARPS_M;
  const int wn = warp / WARPS_M;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    if (!AT) {  // A (M, K): BM rows x 4 chunks of 8
      for (int c = tid; c < BM * (BK / 8); c += THREADS) {
        int r = c >> 2, kc = (c & 3) * 8;
        int gm = m0 + r, gk = k0 + kc;
        bool ok = gm < M && gk < K;
        const __nv_bfloat16* src = ok ? p.A + (size_t)gm * K + gk : p.A;
        cp_async16(As + stage * a_stage<BM, AT>() + r * LDS + kc, src, ok);
      }
    } else {  // A (K, M): BK rows x BM/8 chunks
      for (int c = tid; c < BK * (BM / 8); c += THREADS) {
        int r = c / (BM / 8), mc = (c % (BM / 8)) * 8;
        int gk = k0 + r, gm = m0 + mc;
        bool ok = gk < K && gm < M;
        const __nv_bfloat16* src = ok ? p.A + (size_t)gk * M + gm : p.A;
        cp_async16(As + stage * a_stage<BM, AT>() + r * LDA_T + mc, src, ok);
      }
    }
    if (!BT) {  // B (N, K)
      for (int c = tid; c < BN * (BK / 8); c += THREADS) {
        int r = c >> 2, kc = (c & 3) * 8;
        int gn = n0 + r, gk = k0 + kc;
        bool ok = gn < N && gk < K;
        const __nv_bfloat16* src = ok ? p.B + (size_t)gn * K + gk : p.B;
        cp_async16(Bs + stage * b_stage<BT>() + r * LDS + kc, src, ok);
      }
    } else {  // B (K, N)
      for (int c = tid; c < BK * (BN / 8); c += THREADS) {
        int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
        int gk = k0 + r, gn = n0 + nc;
        bool ok = gk < K && gn < N;
        const __nv_bfloat16* src = ok ? p.B + (size_t)gk * N + gn : p.B;
        cp_async16(Bs + stage * b_stage<BT>() + r * LDB_T + nc, src, ok);
      }
    }
  };

  float acc[2][NT_][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT_; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      int nk = kt + STAGES - 1;
      if (nk < ktiles) load_tile(nk % STAGES, nk);
      cp_async_commit();
    }
    const __nv_bfloat16* a_s = As + (kt % STAGES) * a_stage<BM, AT>();
    const __nv_bfloat16* b_s = Bs + (kt % STAGES) * b_stage<BT>();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A fragments: matrix q of the x4 is (m block q & 1, k block q >> 1)
      unsigned af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!AT) {
          int row = wm * 32 + i * 16 + (lane & 15);
          int col = kk + (lane >> 4) * 8;
          ldmatrix_x4(af[i][0], af[i][1], af[i][2], af[i][3], a_s + row * LDS + col);
        } else {
          int q = lane >> 3;
          int krow = kk + (q >> 1) * 8 + (lane & 7);
          int mcol = wm * 32 + i * 16 + (q & 1) * 8;
          ldmatrix_x4_t(af[i][0], af[i][1], af[i][2], af[i][3], a_s + krow * LDA_T + mcol);
        }
      }
      // B fragments: matrix q is (n block q >> 1, k block q & 1)
      unsigned bf[NT_][2];
#pragma unroll
      for (int j = 0; j < NT_; j += 2) {
        if (!BT) {
          int nrow = wn * WN + j * 8 + (lane & 7) + ((lane >> 4) << 3);
          int col = kk + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(bf[j][0], bf[j][1], bf[j + 1][0], bf[j + 1][1], b_s + nrow * LDS + col);
        } else {
          int q = lane >> 3;
          int krow = kk + (q & 1) * 8 + (lane & 7);
          int ncol = wn * WN + j * 8 + (q >> 1) * 8;
          ldmatrix_x4_t(bf[j][0], bf[j][1], bf[j + 1][0], bf[j + 1][1], b_s + krow * LDB_T + ncol);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT_; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: accumulator (i, j, e) holds row lane/4 (+8 for e >= 2) and
  // columns 2*(lane%4) + {0, 1} of its 16 x 8 tile
  const bool out_f32 = p.flags & OUT_F32;
  const bool res_f32 = p.flags & RES_F32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int m = m0 + wm * 32 + i * 16 + (lane >> 2) + half * 8;
      if (m >= M) continue;
      int rrow = p.R ? (p.ridx ? p.ridx[m] : m) : 0;
      int orow = p.sidx ? p.sidx[m] : m;
      const float rs = p.S ? p.S[m / p.s_div] : 1.f;
#pragma unroll
      for (int j = 0; j < NT_; ++j) {
        int n = n0 + wn * WN + j * 8 + (lane & 3) * 2;
        if (n >= N) continue;
        float v0 = acc[i][j][half * 2 + 0];
        float v1 = acc[i][j][half * 2 + 1];
        if (p.bias) {
          v0 += __bfloat162float(p.bias[n]);
          v1 += __bfloat162float(p.bias[n + 1]);
        }
        size_t pi = (size_t)m * N + n;
        if (p.epi == EPI_GELU_GRAD) {
          float2 a1 = *reinterpret_cast<const float2*>(p.P + pi);
          v0 *= gelu_erf_grad(a1.x);
          v1 *= gelu_erf_grad(a1.y);
        } else if (p.P) {
          *reinterpret_cast<float2*>(p.P + pi) = make_float2(v0, v1);
        }
        if (p.epi == EPI_GELU) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        if (p.E) {
          float2 e2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.E + pi));
          v0 *= e2.x;
          v1 *= e2.y;
        }
        if (p.S) {
          v0 *= rs;
          v1 *= rs;
        }
        if (p.R) {
          size_t ri = (size_t)rrow * N + n;
          if (res_f32) {
            float2 r = *reinterpret_cast<const float2*>(static_cast<const float*>(p.R) + ri);
            v0 += r.x;
            v1 += r.y;
          } else {
            __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
                static_cast<const __nv_bfloat16*>(p.R) + ri);
            v0 += __bfloat162float(r.x);
            v1 += __bfloat162float(r.y);
          }
        }
        size_t oi = (size_t)orow * N + n;
        if (out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(p.Y) + oi) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.Y) + oi) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int BM, int LAYOUT>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  constexpr bool AT = LAYOUT == TN;
  constexpr bool BT = LAYOUT == NN || LAYOUT == TN;
  const int smem = STAGES * (a_stage<BM, AT>() + b_stage<BT>()) * (int)sizeof(__nv_bfloat16);
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(gemm_kernel<BM, LAYOUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  gemm_kernel<BM, LAYOUT><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int LAYOUT>
cudaError_t dispatch(const Args& p, cudaStream_t s) {
  // 128-row tiles when they already give the card's 132 SMs a full wave,
  // 64-row tiles otherwise (e.g. BERT's M = 592 at batch 8)
  long tiles128 = (long)((p.M + 127) / 128) * ((p.N + BN - 1) / BN);
  if (tiles128 >= 132) return launch<128, LAYOUT>(p, s);
  return launch<64, LAYOUT>(p, s);
}

}  // namespace

// layout: 0 NT, 1 NN, 2 TN; epi: 0 none, 1 GELU, 2 GELU'; flags: 1 f32 output, 2 f32 residual.
// P: f32 (M, N) pre-activation, written when given with epi 0/1, read with epi 2.
// E: bf16 (M, N) multiplier applied before the residual add, or null.
// S: f32 row scale applied after E, row m reads S[m / s_div], or null.
extern "C" int mvlt_gemm(const void* A, const void* B, const void* bias, const void* R, const void* ridx,
                         const void* sidx, void* Y, void* P, const void* E, const void* S, int M, int N, int K,
                         int layout, int epi, int flags, int s_div, void* stream) {
  Args p{static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(B),
         static_cast<const __nv_bfloat16*>(bias), R, static_cast<const int*>(ridx),
         static_cast<const int*>(sidx), Y, static_cast<float*>(P), static_cast<const __nv_bfloat16*>(E),
         static_cast<const float*>(S), M, N, K, epi, flags, s_div};
  if (epi == EPI_GELU_GRAD && P == nullptr) return (int)cudaErrorInvalidValue;
  if (S != nullptr && s_div < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case NT: return (int)dispatch<NT>(p, s);
    case NN: return (int)dispatch<NN>(p, s);
    case TN: return (int)dispatch<TN>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
