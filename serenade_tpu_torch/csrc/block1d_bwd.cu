// K6 and K7: the fused Block1D backward of the UNet resnet path.
//
// K6 replaces serenade_tpu/ops/block1d_pallas.py:296 (_fused_block1d_bwd
// -> _bwd_data_kernel, :142) and K7 block1d_pallas.py:343 (_bwd_w_kernel,
// :187).  With yhat = (y - mean) rstd, z = yhat gamma + beta and the
// output cotangent g on the valid frames [0, n):
//   dz    = g (tsp + z (1 - tsp^2) sig)     Mish' from one exponential
//   dgamma = sum dz yhat, dbeta = sum dz     over batch and time
//   dyhat = dz gamma
//   dy    = rstd (dyhat - mean_g(dyhat) - yhat mean_g(dyhat yhat)), 0 on
//           padded frames; dbias = sum dy (from the f32 dy)
//   dx[s] = sum_j dy[s+1-j] W[j]^T        (dy in x's type), 0 on padding
//   K7: dW[co, ci, j] = sum_{b,t} xm[t-1+j, ci] dy[t, co]   (f32)
//
// What bounds them on the H100: at the train-step shape (B 16, T 512,
// Cin 1024, Cout 512, bf16) the dx product is 25.8 GFLOP against ~40 MB
// (x, g, dy, dx, y) and the dW product 25.8 GFLOP against ~35 MB:
// operations bound both products; the two GroupNorm passes are
// elementwise and bound by the bytes of y and g.
//
// Design.  K2 keeps its f32 conv output y and f64 group sums, and K6 reads
// them instead of recomputing the conv as the Pallas kernel does (it held
// a whole (T, C) row in VMEM; here that would be a third product): 16 MB
// a block at the train shape, ~0.2 GB a step.  The GroupNorm backward
// needs two sums per (sample, group) over all valid frames, which one
// block cannot see, so K6 is three kernels:
//   (1) gn_reduce: one block per (64 rows x 64 channels) tile forms dz and
//       dyhat, adds dgamma and dbeta per channel (f32 atomics) and the two
//       group sums (shared-memory then global f64 atomics, K2's pattern);
//   (2) gn_dy: the same tiles form dy, store it in x's type and add dbias;
//   (3) dx: K2's conv with the taps flipped and transposed (bf16 on tensor
//       cores through mma.sync, f32 on FMA units), output masked.
// K7 reduces B T rows into (Cout, Cin, 3): one block per (64 Cout x 64
// Cin) tile and all three taps runs over a chunk of 64-row time tiles
// (split-K; the wrapper picks the chunk count for ~4 waves) and adds its
// sums to dW with f32 atomics.  In bf16 the products run on tensor cores
// with time as the reduction axis: dy and the x window are staged
// transposed, and the x window twice (shifted by one row) so every tap's
// pairs of rows stay 4-byte aligned.
//
// Atomics make the order of the sums over blocks change from run to run.
// Not yet used: wgmma, TMA, and a pipeline overlapping loads with math.
#include "common.cuh"

namespace {

using serenade::from_f;
using serenade::ld32;
using serenade::mma_16816;
using serenade::to_f;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;   // time rows per tile
constexpr int BN = 64;   // channels per tile
constexpr int BKC = 16;  // reduction channels per chunk of the dx conv
constexpr int THREADS = 256;

// mean and rstd of group gi of sample b, as K2's norm_mish_kernel takes
// them from the f64 sums
__device__ __forceinline__ void group_stats(const double* stats, int b, int G,
                                            int gi, int n, int cg, float eps,
                                            float& mean, float& rstd) {
  const double cnt = fmax((double)n * cg, 1.0);
  const double mu = stats[((size_t)b * G + gi) * 2] / cnt;
  const double var = fmax(stats[((size_t)b * G + gi) * 2 + 1] / cnt - mu * mu,
                          0.0);
  mean = (float)mu;
  rstd = rsqrtf((float)var + eps);
}

// yhat and dz of one element
__device__ __forceinline__ void mish_grad(float yv, float gv, float mean,
                                          float rstd, float gam, float bet,
                                          float& yhat, float& dz) {
  yhat = (yv - mean) * rstd;
  const float z = yhat * gam + bet;
  const float u = 1.f + expf(fminf(z, 20.f));
  const float u2 = u * u;
  const float tsp = (u2 - 1.f) / (u2 + 1.f);
  const float sig = (u - 1.f) / u;
  dz = gv * (tsp + z * (1.f - tsp * tsp) * sig);
}

// sum v over the 4 row phases of a tile's column (threads c, c+64, ...);
// the result is valid in threads of phase 0
__device__ __forceinline__ float column_sum(float v, float (*red)[BN]) {
  const int c = threadIdx.x & (BN - 1), rs = threadIdx.x / BN;
  __syncthreads();
  red[rs][c] = v;
  __syncthreads();
  return red[0][c] + red[1][c] + red[2][c] + red[3][c];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_reduce_kernel(const float* __restrict__ y, const int* __restrict__ lengths,
                 const double* __restrict__ stats,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, const T* __restrict__ g,
                 double* __restrict__ gsum, float* __restrict__ dparams,
                 int Tlen, int Cout, int G, float eps) {
  __shared__ float red[4][BN];
  __shared__ double gred[BN][2];
  const int b = blockIdx.z, t0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int c = threadIdx.x & (BN - 1), rs = threadIdx.x / BN;
  const int co = c0 + c, n = lengths[b], cg = Cout / G;
  const bool col = co < Cout;
  const int g_first = c0 / cg;
  for (int i = threadIdx.x; i < BN * 2; i += THREADS) (&gred[0][0])[i] = 0.0;

  float dg = 0.f, db = 0.f, s1 = 0.f, s2 = 0.f;
  if (col) {
    float mean, rstd;
    group_stats(stats, b, G, co / cg, n, cg, eps, mean, rstd);
    const float gam = gamma[co], bet = beta[co];
    for (int r = rs; r < BM; r += 4) {
      const int t = t0 + r;
      if (t >= n) break;
      const size_t idx = ((size_t)b * Tlen + t) * Cout + co;
      float yhat, dz;
      mish_grad(y[idx], to_f(g[idx]), mean, rstd, gam, bet, yhat, dz);
      dg += dz * yhat;
      db += dz;
      const float dyh = dz * gam;
      s1 += dyh;
      s2 += dyh * yhat;
    }
  }
  dg = column_sum(dg, red);
  db = column_sum(db, red);
  s1 = column_sum(s1, red);
  s2 = column_sum(s2, red);
  if (rs == 0 && col) {
    atomicAdd(&dparams[co], dg);
    atomicAdd(&dparams[Cout + co], db);
    const int gl = co / cg - g_first;
    atomicAdd(&gred[gl][0], (double)s1);
    atomicAdd(&gred[gl][1], (double)s2);
  }
  __syncthreads();
  const int c_last = min(c0 + BN, Cout) - 1;
  const int n_groups = c_last / cg - g_first + 1;
  if (threadIdx.x < 2 * n_groups) {
    const int gl = threadIdx.x >> 1, which = threadIdx.x & 1;
    atomicAdd(&gsum[((size_t)b * G + g_first + gl) * 2 + which],
              gred[gl][which]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_dy_kernel(const float* __restrict__ y, const int* __restrict__ lengths,
             const double* __restrict__ stats, const float* __restrict__ gamma,
             const float* __restrict__ beta, const T* __restrict__ g,
             const double* __restrict__ gsum, T* __restrict__ dy,
             float* __restrict__ dbias, int Tlen, int Cout, int G,
             float eps) {
  __shared__ float red[4][BN];
  const int b = blockIdx.z, t0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int c = threadIdx.x & (BN - 1), rs = threadIdx.x / BN;
  const int co = c0 + c, n = lengths[b], cg = Cout / G;
  const bool col = co < Cout;
  float acc = 0.f;
  if (col) {
    const int gi = co / cg;
    float mean, rstd;
    group_stats(stats, b, G, gi, n, cg, eps, mean, rstd);
    const double cnt = fmax((double)n * cg, 1.0);
    const float a1 = (float)(gsum[((size_t)b * G + gi) * 2] / cnt);
    const float a2 = (float)(gsum[((size_t)b * G + gi) * 2 + 1] / cnt);
    const float gam = gamma[co], bet = beta[co];
    for (int r = rs; r < BM; r += 4) {
      const int t = t0 + r;
      if (t >= Tlen) break;
      const size_t idx = ((size_t)b * Tlen + t) * Cout + co;
      float d = 0.f;
      if (t < n) {
        float yhat, dz;
        mish_grad(y[idx], to_f(g[idx]), mean, rstd, gam, bet, yhat, dz);
        d = rstd * (dz * gam - a1 - yhat * a2);
      }
      dy[idx] = from_f<T>(d);
      acc += d;
    }
  }
  acc = column_sum(acc, red);
  if (rs == 0 && col) atomicAdd(&dbias[co], acc);
}

// dx[s, o] = sum_j sum_i dy[s - 1 + j, i] W[i, o, 2 - j] over the valid
// rows of dy (zeros outside [0, n)), 0 for s >= n.  o runs over Cin, i over
// Cout.  f32 on FMA units: K2's conv_stats_kernel with the weight read
// flipped and transposed.
__global__ void __launch_bounds__(THREADS)
dx_f32_kernel(const float* __restrict__ dy, const int* __restrict__ lengths,
              const float* __restrict__ w, float* __restrict__ dx, int Tlen,
              int Cin, int Cout) {
  __shared__ float Xs[BKC][BM + 2];
  __shared__ float4 Ws4[3][BKC][BN / 4];
  const int b = blockIdx.z, t0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n = lengths[b];
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const float* db = dy + (size_t)b * Tlen * Cout;
  float* Wsf = reinterpret_cast<float*>(&Ws4[0][0][0]);
  for (int i0 = 0; i0 < Cout; i0 += BKC) {
    __syncthreads();
    for (int i = tid; i < BKC * (BM + 2); i += THREADS) {
      const int il = i % BKC, rr = i / BKC;
      const int t = t0 - 1 + rr, ch = i0 + il;
      Xs[il][rr] = (t >= 0 && t < n && ch < Cout)
                       ? db[(size_t)t * Cout + ch] : 0.f;
    }
    // W (Cout, Cin, 3): for input channel i the (o, tap) run is contiguous
    for (int i = tid; i < BKC * BN * 3; i += THREADS) {
      const int il = i / (BN * 3), rem = i - il * (BN * 3);
      const int o = rem / 3, jj = rem - o * 3;
      const int gi = i0 + il, go = c0 + o;
      Wsf[((2 - jj) * BKC + il) * BN + o] =
          (gi < Cout && go < Cin) ? w[((size_t)gi * Cin + go) * 3 + jj] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int il = 0; il < BKC; ++il) {
      float a[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) a[i] = Xs[il][4 * ty + i];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 bw = Ws4[j][il][tx];
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * ty + i;
    if (t >= Tlen) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int o = c0 + 4 * tx + c;
      if (o < Cin) dx[((size_t)b * Tlen + t) * Cin + o] = t < n ? acc[i][c]
                                                                 : 0.f;
    }
  }
}

constexpr int TC_THREADS = 128;
constexpr int XS_LD = BKC + 8;   // staged row: 16 channels + 8 padding

// bf16 dx on tensor cores: K2's conv_stats_bf16_kernel (4 warps, each 16
// rows x 64 output channels) with the weight read flipped and transposed
__global__ void __launch_bounds__(TC_THREADS)
dx_bf16_kernel(const bf16* __restrict__ dy, const int* __restrict__ lengths,
               const bf16* __restrict__ w, bf16* __restrict__ dx, int Tlen,
               int Cin, int Cout) {
  __shared__ __align__(16) bf16 Xs[BM + 2][XS_LD];
  __shared__ __align__(16) bf16 Ws[3][BN][XS_LD];
  const int b = blockIdx.z, t0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n = lengths[b];
  const bf16 zero = __float2bfloat16(0.f);

  float acc[BN / 8][4];
#pragma unroll
  for (int nn = 0; nn < BN / 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;

  const bf16* db = dy + (size_t)b * Tlen * Cout;
  for (int i0 = 0; i0 < Cout; i0 += BKC) {
    __syncthreads();
    for (int i = tid; i < (BM + 2) * BKC; i += TC_THREADS) {
      const int rr = i / BKC, il = i - rr * BKC;
      const int t = t0 - 1 + rr, ch = i0 + il;
      Xs[rr][il] = (t >= 0 && t < n && ch < Cout) ? db[(size_t)t * Cout + ch]
                                                  : zero;
    }
    for (int i = tid; i < BKC * BN * 3; i += TC_THREADS) {
      const int il = i / (BN * 3), rem = i - il * (BN * 3);
      const int o = rem / 3, jj = rem - o * 3;
      const int gi = i0 + il, go = c0 + o;
      Ws[2 - jj][o][il] = (gi < Cout && go < Cin)
                              ? w[((size_t)gi * Cin + go) * 3 + jj] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      // output row r reads dy row r - 1 + j, staged at Xs row r + j
      const int r = 16 * warp + g + j;
      const uint32_t a[4] = {ld32(&Xs[r][2 * t4]), ld32(&Xs[r + 8][2 * t4]),
                             ld32(&Xs[r][2 * t4 + 8]),
                             ld32(&Xs[r + 8][2 * t4 + 8])};
#pragma unroll
      for (int nn = 0; nn < BN / 8; ++nn) {
        const bf16* wp = &Ws[j][8 * nn + g][2 * t4];
        mma_16816(acc[nn], a, ld32(wp), ld32(wp + 8));
      }
    }
  }
  // element e of tile nn: row 16 warp + g + 8 (e >> 1), column
  // 8 nn + 2 t4 + (e & 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + 16 * warp + g + 8 * h;
    if (t >= Tlen) continue;
#pragma unroll
    for (int nn = 0; nn < BN / 8; ++nn) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int o = c0 + 8 * nn + 2 * t4 + p;
        if (o < Cin)
          dx[((size_t)b * Tlen + t) * Cin + o] =
              __float2bfloat16(t < n ? acc[nn][2 * h + p] : 0.f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K7: dW[co, ci, j] = sum over (b, t) of xm[t - 1 + j, ci] dy[t, co]
// ---------------------------------------------------------------------------

// the 64-row time tiles [first, last) of this block's chunk
__device__ __forceinline__ void chunk_range(int total, int nchunks, int& first,
                                            int& last) {
  first = (int)((long long)blockIdx.z * total / nchunks);
  last = (int)((long long)(blockIdx.z + 1) * total / nchunks);
}

__device__ __forceinline__ void add_dw(float* dw, int co, int ci, int j,
                                       int Cin, int Cout, float v) {
  if (co < Cout && ci < Cin)
    atomicAdd(&dw[((size_t)co * Cin + ci) * 3 + j], v);
}

// f32: 256 threads, each 4 Cout x 4 Cin x 3 taps
__global__ void __launch_bounds__(THREADS)
dw_f32_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
              const float* __restrict__ dy, float* __restrict__ dw, int B,
              int Tlen, int Cin, int Cout, int nchunks) {
  __shared__ __align__(16) float dys[BM][BN];       // [t][co]
  __shared__ __align__(16) float xw[BM + 2][BN];    // [window row][ci]
  const int co0 = blockIdx.x * BN, ci0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tps = (Tlen + BM - 1) / BM;
  int first, last;
  chunk_range(B * tps, nchunks, first, last);
  float acc[3][4][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][i][c] = 0.f;

  for (int tile = first; tile < last; ++tile) {
    const int b = tile / tps, t0 = (tile - b * tps) * BM, n = lengths[b];
    __syncthreads();
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i - r * BN;
      const int t = t0 + r, co = co0 + c;
      dys[r][c] = (t < Tlen && co < Cout)
                      ? dy[((size_t)b * Tlen + t) * Cout + co] : 0.f;
    }
    for (int i = tid; i < (BM + 2) * BN; i += THREADS) {
      const int r = i / BN, c = i - r * BN;
      const int t = t0 - 1 + r, ci = ci0 + c;
      xw[r][c] = (t >= 0 && t < n && ci < Cin)
                     ? x[((size_t)b * Tlen + t) * Cin + ci] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BM; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&dys[r][4 * ty]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 bb = *reinterpret_cast<const float4*>(&xw[r + j][4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[j][i][0] += av[i] * bb.x;
          acc[j][i][1] += av[i] * bb.y;
          acc[j][i][2] += av[i] * bb.z;
          acc[j][i][3] += av[i] * bb.w;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        add_dw(dw, co0 + 4 * ty + i, ci0 + 4 * tx + c, j, Cin, Cout,
               acc[j][i][c]);
}

constexpr int LDT = BM + 10;   // staged time rows: 66 used, odd word count

// bf16: 8 warps on tensor cores, warp w owns Cout rows 16 (w % 4) and Cin
// columns 32 (w / 4) for all three taps; time is the reduction axis
__global__ void __launch_bounds__(THREADS)
dw_bf16_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
               const bf16* __restrict__ dy, float* __restrict__ dw, int B,
               int Tlen, int Cin, int Cout, int nchunks) {
  __shared__ __align__(16) bf16 dyT[BN][LDT];   // [co][t]
  __shared__ __align__(16) bf16 xe[BN][LDT];    // [ci][window row]
  __shared__ __align__(16) bf16 xo[BN][LDT];    // xe shifted by one row
  const int co0 = blockIdx.x * BN, ci0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = 16 * (warp & 3), wn = 32 * (warp >> 2);
  const int tps = (Tlen + BM - 1) / BM;
  const bf16 zero = __float2bfloat16(0.f);
  int first, last;
  chunk_range(B * tps, nchunks, first, last);
  float acc[3][4][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nn][e] = 0.f;

  for (int tile = first; tile < last; ++tile) {
    const int b = tile / tps, t0 = (tile - b * tps) * BM, n = lengths[b];
    __syncthreads();
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i - r * BN;
      const int t = t0 + r, co = co0 + c;
      dyT[c][r] = (t < Tlen && co < Cout)
                      ? dy[((size_t)b * Tlen + t) * Cout + co] : zero;
    }
    for (int i = tid; i < (BM + 2) * BN; i += THREADS) {
      const int r = i / BN, c = i - r * BN;
      const int t = t0 - 1 + r, ci = ci0 + c;
      const bf16 v = (t >= 0 && t < n && ci < Cin)
                         ? x[((size_t)b * Tlen + t) * Cin + ci] : zero;
      xe[c][r] = v;
      if (r > 0) xo[c][r - 1] = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BM / 16; ++ks) {
      const bf16* ap = &dyT[wm + g][16 * ks + 2 * t4];
      const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * LDT), ld32(ap + 8),
                             ld32(ap + 8 * LDT + 8)};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        // tap j reads window row r + j: rows r + 1 sit at xo[.][r]
        const int off = 16 * ks + 2 * t4 + (j == 2 ? 2 : 0);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const bf16* bp = j == 1 ? &xo[wn + 8 * nn + g][off]
                                  : &xe[wn + 8 * nn + g][off];
          mma_16816(acc[j][nn], a, ld32(bp), ld32(bp + 8));
        }
      }
    }
  }
  // element e of tile (j, nn): Cout row wm + g + 8 (e >> 1), Cin column
  // wn + 8 nn + 2 t4 + (e & 1)
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        add_dw(dw, co0 + wm + g + 8 * (e >> 1),
               ci0 + wn + 8 * nn + 2 * t4 + (e & 1), j, Cin, Cout,
               acc[j][nn][e]);
}

}  // namespace

// dparams (3, Cout) f32, zeroed: dgamma, dbeta, dbias; gsum (B, G, 2) f64,
// zeroed: the group sums of dyhat and dyhat yhat
extern "C" int serenade_block1d_bwd_data(
    const int* lengths, const void* w, const float* y,
    const double* stats, const float* gamma, const float* beta, const void* g,
    double* gsum, void* dx, void* dy, float* dparams, int B, int Tlen,
    int Cin, int Cout, int G, float eps, int dtype, cudaStream_t stream) {
  if (B <= 0 || Tlen <= 0 || Cin <= 0 || Cout <= 0 || Cout % G != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 gn_grid((Tlen + BM - 1) / BM, (Cout + BN - 1) / BN, B);
  const dim3 dx_grid((Tlen + BM - 1) / BM, (Cin + BN - 1) / BN, B);
  SERENADE_DISPATCH(dtype, {
    gn_reduce_kernel<T><<<gn_grid, THREADS, 0, stream>>>(
        y, lengths, stats, gamma, beta, static_cast<const T*>(g), gsum,
        dparams, Tlen, Cout, G, eps);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    gn_dy_kernel<T><<<gn_grid, THREADS, 0, stream>>>(
        y, lengths, stats, gamma, beta, static_cast<const T*>(g), gsum,
        static_cast<T*>(dy), dparams + 2 * Cout, Tlen, Cout, G, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (dtype == 1) {
      dx_bf16_kernel<<<dx_grid, TC_THREADS, 0, stream>>>(
          static_cast<const bf16*>(dy), lengths, static_cast<const bf16*>(w),
          static_cast<bf16*>(dx), Tlen, Cin, Cout);
    } else {
      dx_f32_kernel<<<dx_grid, THREADS, 0, stream>>>(
          static_cast<const float*>(dy), lengths,
          static_cast<const float*>(w), static_cast<float*>(dx), Tlen, Cin,
          Cout);
    }
  });
  return (int)cudaGetLastError();
}

// dw (Cout, Cin, 3) f32, zeroed
extern "C" int serenade_block1d_bwd_weight(const void* x, const int* lengths,
                                           const void* dy, float* dw, int B,
                                           int Tlen, int Cin, int Cout,
                                           int nchunks, int dtype,
                                           cudaStream_t stream) {
  if (B <= 0 || Tlen <= 0 || Cin <= 0 || Cout <= 0 || nchunks <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Cout + BN - 1) / BN, (Cin + BN - 1) / BN, nchunks);
  if (dtype == 1) {
    dw_bf16_kernel<<<grid, THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), lengths, static_cast<const bf16*>(dy),
        dw, B, Tlen, Cin, Cout, nchunks);
  } else if (dtype == 0) {
    dw_f32_kernel<<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(x), lengths, static_cast<const float*>(dy),
        dw, B, Tlen, Cin, Cout, nchunks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
