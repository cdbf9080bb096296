// K3: one dilation stage of a HiFiGAN residual branch.
//
// Replaces serenade_tpu/ops/resblock_pallas.py:154 (resblock_branch_pallas
// -> _branch_kernel): per dilation d, h += conv_k(lrelu(conv_k,d(lrelu(h)))),
// lrelu slope 0.1, with zeros outside [0, T) before every conv (torch
// "same" padding, the edge-tile semantics of resblock_pallas.py:58-63).
//
// What bounds it on the H100: a stage at C 256, k 11, T 8192 is 2.2 GFLOP
// against 8 MB of activations in bf16, so operations bound it; the C 64
// levels at T 245760 move 63 MB for 2.0 GFLOP and sit near the ridge.
// The weights (k * C * C, 2.9 MB per conv at C 256, k 11 in f32) do not
// fit in shared memory beside the activations.
//
// Design: one launch per dilation stage (the wrapper chains three), so a
// branch reads and writes h three times instead of once; the second
// conv's halo is recomputed by each tile.  One block of 256 threads per
// (batch row, tile of BT time rows) keeps the tile's f32 input window,
// lrelu'd and zeroed outside [0, T) (BT + 2 p2 + 2 p1 rows), and the first
// conv's output window (BT + 2 p2 rows) in shared memory, rows padded to
// C + 1 floats; the host picks BT so both fit in 200 KB and the first conv
// fills whole row passes.  Weights stream from global memory (L2) in
// 16-channel tiles per tap, staged through shared memory.  Each conv is a
// product of rows by (k taps x C) by C on FMA units with an 8 x 8 f32
// register tile per thread (f32 is the vocoder's type, so no tensor cores).
#include "common.cuh"

namespace {

using serenade::from_f;
using serenade::lrelu;
using serenade::to_f;

constexpr int THREADS = 256;
constexpr int TK = 16;        // input channels per weight tile
constexpr int MAX_TN = 256;   // output channels per pass

// out[r][co] = sum_j sum_ci A[(r + j*dil) * lda + ci] * W[(j*C + ci)*C + co]
// for r < M, co < C; calls epi(r, co, value) for each.  A pass covers
// TN = min(C, 256) columns and TM = 8 * 256 / (TN / 8) rows: each thread
// owns an 8 x 8 tile (rows 8 ty .. +7, columns 4 tx .. +3 and
// TN/2 + 4 tx .. +3), so one weight row feeds 64 FMAs from 8 scalar and
// 2 float4 shared-memory loads.  lda = C + 1 puts the row groups of a
// warp in distinct banks.
template <typename T, typename Epi>
__device__ void conv_rows(const float* A, int lda, int M, int C, int k,
                          int dil, const T* __restrict__ W, float* Ws,
                          Epi epi) {
  const int tn = min(C, MAX_TN);
  const int tx_n = tn / 8, ty_n = THREADS / tx_n, tm = 8 * ty_n;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const float4* Ws4 = reinterpret_cast<const float4*>(Ws);
  for (int m0 = 0; m0 < M; m0 += tm) {
    for (int n0 = 0; n0 < C; n0 += tn) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
      int rows[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) rows[i] = min(m0 + 8 * ty + i, M - 1);
      for (int j = 0; j < k; ++j) {
        for (int ci0 = 0; ci0 < C; ci0 += TK) {
          __syncthreads();
          for (int i = threadIdx.x; i < TK * tn; i += THREADS) {
            const int ci = i / tn, co = i - ci * tn;
            const int gci = ci0 + ci;
            Ws[i] = gci < C ? to_f(W[((size_t)j * C + gci) * C + n0 + co])
                            : 0.f;
          }
          __syncthreads();
          const int kc = min(TK, C - ci0);
          const float* Aj = A + (size_t)j * dil * lda + ci0;
          for (int ci = 0; ci < kc; ++ci) {
            const float4 b0 = Ws4[ci * (tn / 4) + tx];
            const float4 b1 = Ws4[ci * (tn / 4) + tx_n + tx];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float a = Aj[rows[i] * lda + ci];
              acc[i][0] += a * b0.x;
              acc[i][1] += a * b0.y;
              acc[i][2] += a * b0.z;
              acc[i][3] += a * b0.w;
              acc[i][4] += a * b1.x;
              acc[i][5] += a * b1.y;
              acc[i][6] += a * b1.z;
              acc[i][7] += a * b1.w;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = m0 + 8 * ty + i;
        if (r >= M) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int co = n0 + (c < 4 ? 4 * tx + c : tn / 2 + 4 * tx + c - 4);
          epi(r, co, acc[i][c]);
        }
      }
    }
  }
}

// one block per SM by its shared memory: let ptxas use up to 255 registers
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
stage_kernel(const T* __restrict__ h, const T* __restrict__ w1,
             const float* __restrict__ b1, const T* __restrict__ w2,
             const float* __restrict__ b2, T* __restrict__ out, int Tlen,
             int C, int k, int d, int add, int BT) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BT;
  const int p1 = (k - 1) / 2 * d;
  const int p2 = add ? (k - 1) / 2 : 0;
  const int R2 = BT + 2 * p2;
  const int R1 = R2 + 2 * p1;
  const int lda = C + 1;
  float* A1 = smem;                          // R1 x lda
  float* A2 = A1 + (size_t)R1 * lda;         // R2 x lda (add only)
  float* Ws = smem + (((size_t)R1 * lda + (add ? (size_t)R2 * lda : 0) + 3)
                      & ~(size_t)3);         // TK x min(C, 256), 16B aligned

  const T* hb = h + (size_t)b * Tlen * C;
  T* ob = out + (size_t)b * Tlen * C;
  const int s1 = t0 - p2 - p1;
  for (int i = threadIdx.x; i < R1 * C; i += THREADS) {
    const int r = i / C, c = i - r * C;
    const int t = s1 + r;
    A1[r * lda + c] =
        (t >= 0 && t < Tlen) ? lrelu(to_f(hb[(size_t)t * C + c]), 0.1f) : 0.f;
  }
  __syncthreads();

  if (add) {
    const int s2 = t0 - p2;
    conv_rows<T>(A1, lda, R2, C, k, d, w1, Ws, [&](int r, int co, float v) {
      const int t = s2 + r;
      A2[r * lda + co] =
          (t >= 0 && t < Tlen) ? lrelu(v + b1[co], 0.1f) : 0.f;
    });
    __syncthreads();
    conv_rows<T>(A2, lda, BT, C, k, 1, w2, Ws, [&](int r, int co, float v) {
      const int t = t0 + r;
      if (t < Tlen) {
        const size_t o = (size_t)t * C + co;
        ob[o] = from_f<T>(to_f(hb[o]) + v + b2[co]);
      }
    });
  } else {
    conv_rows<T>(A1, lda, BT, C, k, d, w1, Ws, [&](int r, int co, float v) {
      const int t = t0 + r;
      if (t < Tlen) {
        const size_t o = (size_t)t * C + co;
        ob[o] = from_f<T>(to_f(hb[o]) + v + b1[co]);
      }
    });
  }
}

}  // namespace

extern "C" int serenade_resblock_stage(const void* h, const void* w1,
                                       const float* b1, const void* w2,
                                       const float* b2, void* out, int B,
                                       int Tlen, int C, int k, int d, int add,
                                       int BT, int smem, int dtype,
                                       cudaStream_t stream) {
  const int tn = C < MAX_TN ? C : MAX_TN;
  if (B <= 0 || Tlen <= 0 || k % 2 != 1 || BT <= 0 || tn % 8 ||
      THREADS % (tn / 8) || C % tn)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Tlen + BT - 1) / BT, B);
  SERENADE_DISPATCH(dtype, {
    cudaError_t e = cudaFuncSetAttribute(
        stage_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    stage_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(h), static_cast<const T*>(w1), b1,
        static_cast<const T*>(w2), b2, static_cast<T*>(out), Tlen, C, k, d,
        add, BT);
  });
  return (int)cudaGetLastError();
}
