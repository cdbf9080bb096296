// K2: fused Block1D forward for the UNet resnet path.
//
// Replaces serenade_tpu/ops/block1d_pallas.py:255 (_fused_block1d_fwd ->
// _fwd_kernel): out = mish(masked_group_norm(conv_k3(x * mask) + b)) * mask
// with 8 groups, eps 1e-5, and prefix masks given as lengths.
//
// What bounds it on the H100: the k=3 conv is a product of T rows by
// 3*Cin by Cout (at T 1536, Cin 1024, Cout 512: 4.8 GFLOP against 4.7 MB),
// so operations bound it.  On the TPU one grid step held a whole (T, C)
// row in VMEM and normalized it in place; here one block cannot hold a
// row, and GroupNorm needs statistics over every valid frame of a group.
//
// Design: two kernels.  (1) conv_stats: one block per (64 time rows x 64
// output channels) tile loops over Cin in chunks of 16, staging the masked
// input window (66 rows, zeros outside [0, n)) and the three taps of the
// weight chunk in shared memory.  In bf16 (the serving path) 4 warps run
// the products on tensor cores (mma.sync m16n8k16, f32 accumulation), each
// warp 16 rows x 64 channels, the three taps being row shifts of one
// window; in f32 (parity checks) 256 threads accumulate 4 x 4 tiles on FMA
// units (6 input reads serve all 3 taps).  Either writes conv + bias to an
// f32 scratch and adds each group's sum and sum of squares over valid rows
// into f64 statistics (shared-memory then global atomics; f64 keeps the
// single-pass variance E[y^2] - mu^2 close to the two-pass one).
// (2) norm_mish: an elementwise pass that normalizes, applies the f32
// affine, a single-exponential Mish and the mask.  Any Cin works (the TPU
// gate cin % 128 does not apply).
#include "common.cuh"

namespace {

using serenade::from_f;
using serenade::ld32;
using serenade::mma_16816;
using serenade::to_f;

constexpr int BM = 64;   // time rows per tile
constexpr int BN = 64;   // output channels per tile
constexpr int BKC = 16;  // input channels per chunk
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_stats_kernel(const T* __restrict__ x, const int* __restrict__ lengths,
                  const T* __restrict__ w, const float* __restrict__ bias,
                  float* __restrict__ y, double* __restrict__ stats, int Tlen,
                  int Cin, int Cout, int G) {
  __shared__ float Xs[BKC][BM + 2];
  __shared__ float4 Ws4[3][BKC][BN / 4];
  __shared__ double red[BN][2];

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n = lengths[b];
  const int cg = Cout / G;
  const int g_first = c0 / cg;

  for (int i = tid; i < BN * 2; i += THREADS) (&red[0][0])[i] = 0.0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const T* xb = x + (size_t)b * Tlen * Cin;
  float* Wsf = reinterpret_cast<float*>(&Ws4[0][0][0]);
  for (int ci0 = 0; ci0 < Cin; ci0 += BKC) {
    __syncthreads();
    for (int i = tid; i < BKC * (BM + 2); i += THREADS) {
      const int ci = i % BKC, rr = i / BKC;
      const int t = t0 - 1 + rr, c = ci0 + ci;
      Xs[ci][rr] = (t >= 0 && t < n && c < Cin)
                       ? to_f(xb[(size_t)t * Cin + c]) : 0.f;
    }
    // weight (Cout, Cin, 3): 48 contiguous values per output channel
    for (int i = tid; i < BN * BKC * 3; i += THREADS) {
      const int co = i / (BKC * 3), rem = i - co * (BKC * 3);
      const int ci = rem / 3, j = rem - ci * 3;
      const int gco = c0 + co, gci = ci0 + ci;
      Wsf[(j * BKC + ci) * BN + co] =
          (gco < Cout && gci < Cin)
              ? to_f(w[((size_t)gco * Cin + gci) * 3 + j]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int ci = 0; ci < BKC; ++ci) {
      float a[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) a[i] = Xs[ci][4 * ty + i];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 bw = Ws4[j][ci][tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] += a[i + j] * bw.x;
          acc[i][1] += a[i + j] * bw.y;
          acc[i][2] += a[i + j] * bw.z;
          acc[i][3] += a[i + j] * bw.w;
        }
      }
    }
  }

  // epilogue: + bias, store, per-group partial sums over valid rows
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int co = c0 + 4 * tx + c;
    if (co >= Cout) continue;
    const float bc = bias[co];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + 4 * ty + i;
      const float val = acc[i][c] + bc;
      if (t < Tlen) y[((size_t)b * Tlen + t) * Cout + co] = val;
      if (t < n) {
        s1 += val;
        s2 += val * val;
      }
    }
    const int gl = co / cg - g_first;
    atomicAdd(&red[gl][0], (double)s1);
    atomicAdd(&red[gl][1], (double)s2);
  }
  __syncthreads();
  const int c_last = min(c0 + BN, Cout) - 1;
  const int n_groups = c_last / cg - g_first + 1;
  if (tid < 2 * n_groups) {
    const int gl = tid >> 1, which = tid & 1;
    atomicAdd(&stats[((size_t)b * G + g_first + gl) * 2 + which],
              red[gl][which]);
  }
}

constexpr int TC_THREADS = 128;
constexpr int XS_LD = BKC + 8;   // staged row: 16 channels + 8 padding (banks)

__global__ void __launch_bounds__(TC_THREADS)
conv_stats_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const int* __restrict__ lengths,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ y,
                       double* __restrict__ stats, int Tlen, int Cin,
                       int Cout, int G) {
  __shared__ __align__(16) __nv_bfloat16 Xs[BM + 2][XS_LD];
  __shared__ __align__(16) __nv_bfloat16 Ws[3][BN][XS_LD];
  __shared__ double red[BN][2];

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n = lengths[b];
  const int cg = Cout / G;
  const int g_first = c0 / cg;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < BN * 2; i += TC_THREADS) (&red[0][0])[i] = 0.0;

  float acc[BN / 8][4];
#pragma unroll
  for (int nn = 0; nn < BN / 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;

  const __nv_bfloat16* xb = x + (size_t)b * Tlen * Cin;
  for (int ci0 = 0; ci0 < Cin; ci0 += BKC) {
    __syncthreads();
    for (int i = tid; i < (BM + 2) * BKC; i += TC_THREADS) {
      const int rr = i / BKC, ci = i - rr * BKC;
      const int t = t0 - 1 + rr, c = ci0 + ci;
      Xs[rr][ci] = (t >= 0 && t < n && c < Cin) ? xb[(size_t)t * Cin + c]
                                                : zero;
    }
    // weight (Cout, Cin, 3): 48 contiguous values per output channel
    for (int i = tid; i < BN * BKC * 3; i += TC_THREADS) {
      const int co = i / (BKC * 3), rem = i - co * (BKC * 3);
      const int ci = rem / 3, j = rem - ci * 3;
      const int gco = c0 + co, gci = ci0 + ci;
      Ws[j][co][ci] = (gco < Cout && gci < Cin)
                          ? w[((size_t)gco * Cin + gci) * 3 + j] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      // output row r reads input row r - 1 + j, staged at Xs row r + j
      const int r = 16 * warp + g + j;
      const uint32_t a[4] = {ld32(&Xs[r][2 * t4]), ld32(&Xs[r + 8][2 * t4]),
                             ld32(&Xs[r][2 * t4 + 8]),
                             ld32(&Xs[r + 8][2 * t4 + 8])};
#pragma unroll
      for (int nn = 0; nn < BN / 8; ++nn) {
        const __nv_bfloat16* wp = &Ws[j][8 * nn + g][2 * t4];
        mma_16816(acc[nn], a, ld32(wp), ld32(wp + 8));
      }
    }
  }

  // epilogue: + bias, store, per-group sums over valid rows.  Element e of
  // tile nn is row 16 warp + g + 8 (e >> 1), column 8 nn + 2 t4 + (e & 1).
  const int row0 = t0 + 16 * warp + g;
#pragma unroll
  for (int nn = 0; nn < BN / 8; ++nn) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int co = c0 + 8 * nn + 2 * t4 + p;
      const bool col_ok = co < Cout;
      const float bc = col_ok ? bias[co] : 0.f;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = row0 + 8 * h;
        const float val = acc[nn][p + 2 * h] + bc;
        if (col_ok && t < Tlen) y[((size_t)b * Tlen + t) * Cout + co] = val;
        if (t < n) {
          s1 += val;
          s2 += val * val;
        }
      }
      // sum the 8 lanes (g = 0..7) that hold this column
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (g == 0 && col_ok) {
        const int gl = co / cg - g_first;
        atomicAdd(&red[gl][0], (double)s1);
        atomicAdd(&red[gl][1], (double)s2);
      }
    }
  }
  __syncthreads();
  const int c_last = min(c0 + BN, Cout) - 1;
  const int n_groups = c_last / cg - g_first + 1;
  if (tid < 2 * n_groups) {
    const int gl = tid >> 1, which = tid & 1;
    atomicAdd(&stats[((size_t)b * G + g_first + gl) * 2 + which],
              red[gl][which]);
  }
}

template <typename T>
__global__ void norm_mish_kernel(const float* __restrict__ y,
                                 const int* __restrict__ lengths,
                                 const double* __restrict__ stats,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta,
                                 T* __restrict__ out, int Tlen, int Cout,
                                 int G, float eps, long long total4) {
  const long long i4 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i4 >= total4) return;
  const long long e = i4 * 4;
  const int co0 = (int)(e % Cout);
  const long long bt = e / Cout;
  const int t = (int)(bt % Tlen);
  const int b = (int)(bt / Tlen);
  const int n = lengths[b];
  const float4 v = reinterpret_cast<const float4*>(y)[i4];
  const float vals[4] = {v.x, v.y, v.z, v.w};
  const int cg = Cout / G;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float o = 0.f;
    if (t < n) {
      const int co = co0 + c;
      const int g = co / cg;
      const double cnt = fmax((double)n * cg, 1.0);
      const double mean = stats[((size_t)b * G + g) * 2] / cnt;
      const double var =
          fmax(stats[((size_t)b * G + g) * 2 + 1] / cnt - mean * mean, 0.0);
      const float rstd = rsqrtf((float)var + eps);
      const float z = (vals[c] - (float)mean) * rstd * gamma[co] + beta[co];
      // mish(z) = z * tanh(softplus(z)) with one exponential:
      // tanh(log(1 + e)) = e (e + 2) / (e (e + 2) + 2)
      const float ez = expf(fminf(z, 20.f));
      const float num = ez * (ez + 2.f);
      o = z * num / (num + 2.f);
    }
    out[e + c] = from_f<T>(o);
  }
}

}  // namespace

extern "C" int serenade_block1d_fwd(const void* x, const int* lengths,
                                    const void* w, const float* bias,
                                    const float* gamma, const float* beta,
                                    float* y, double* stats, void* out, int B,
                                    int Tlen, int Cin, int Cout, int G,
                                    float eps, int dtype,
                                    cudaStream_t stream) {
  if (B <= 0 || Tlen <= 0 || Cin <= 0 || Cout % 4 != 0 || Cout % G != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Tlen + BM - 1) / BM, (Cout + BN - 1) / BN, B);
  const long long total4 = (long long)B * Tlen * Cout / 4;
  const int nb = (int)((total4 + 255) / 256);
  SERENADE_DISPATCH(dtype, {
    if (dtype == 1) {
      conv_stats_bf16_kernel<<<grid, TC_THREADS, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(x), lengths,
          static_cast<const __nv_bfloat16*>(w), bias, y, stats, Tlen, Cin,
          Cout, G);
    } else {
      conv_stats_kernel<float><<<grid, THREADS, 0, stream>>>(
          static_cast<const float*>(x), lengths,
          static_cast<const float*>(w), bias, y, stats, Tlen, Cin, Cout, G);
    }
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    norm_mish_kernel<T><<<nb, 256, 0, stream>>>(
        y, lengths, stats, gamma, beta, static_cast<T*>(out), Tlen, Cout, G,
        eps, total4);
  });
  return (int)cudaGetLastError();
}
