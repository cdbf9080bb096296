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
//       group sums (f64: a warp's channels by shuffles where they share a
//       group, then shared-memory and global atomics, K2's pattern);
//   (2) gn_dy: the same tiles form dy, store it in x's type and add dbias.
//   Both load all of a thread's 16 rows before using any, so a tile waits
//   on memory once; they still take some 3 x their bytes' time at the
//   train shape, for reasons not yet settled;
//   (3) dx: K2's conv with the taps flipped and transposed, output masked.
//   f32 (parity checks): 64 x 64 tiles on FMA units.  bf16 (the train
//   step), designed for Hopper: one CTA of 384 threads per (128 rows x BN
//   Cin) tile, BN 256 or 128 as ops/block1d_cuda.py k6_plan fills the
//   card (K2's 64 x 128 tile reached 15 % of its bound at this product's
//   size).  The weight is K2's own taps (ops/block1d_cuda.py k2_taps, (3,
//   Cout, Cin8), Cin contiguous), made once per weight version by the
//   forward and read here as B MN-major (the descriptor's transpose bit),
//   tap 2 - j for step j, so no CTA transposes it and the backward makes
//   no taps of its own.  Warpgroup 0 keeps a TMA ring of (64-channel
//   chunk, tap) stages full: a 128-row dy box at rows t0 - 1 + j through
//   a 3-D (Cout, T, B) map, which zero-fills t = -1 and t >= T (dy is 0
//   on n <= t < T, as gn_dy writes it, so nothing is masked in shared
//   memory), and BN / 64 boxes of 64 Cin x 64 Cout of that tap through a
//   3-D (Cin8, Cout, 3) map, which zero-fills Cin >= Cin8.  Warpgroups 1
//   and 2 each own 64 rows x BN columns and run wgmma m64nBNk16, one
//   group in flight while the next stage is waited for.
//   The epilogue zeroes rows >= n and stages the tile in the ring, then
//   stores 16 bytes a thread along dx's rows; Cin 242 (484-byte rows, not
//   16-byte aligned) stores bf16 pairs from the registers.  Tiles wholly
//   at or past n store zeros and skip the products.  At (16, 512, 1024 ->
//   512) the dx product takes 39 us (its bound 26 us; its mainloop at
//   87 % of the tensor cores' rate), cuDNN's conv1d data gradient 109 us,
//   and the two GroupNorm passes 25 + 20 us (NVIDIA H100 80GB HBM3,
//   700 W).
// K7 reduces B T rows into (Cout, Cin, 3), time being the reduction axis
// of a plain GEMM: A = dy [t][co] (M = Cout), B = the x window [t][ci]
// (N = Cin), both with their M or N axis contiguous in memory.
//   f32 (parity checks): one block per (64 Cout x 64 Cin) tile and all
//   three taps over a split of the 64-row time tiles, FMA units, f32
//   atomics into dW.
//   bf16 (the train step), designed for Hopper: one CTA of 384 threads per
//   (128 Cout x 64 Cin) tile and split.  Warpgroup 0 loads a ring of 4
//   stages of 40 KB: two 64 x 64 dy boxes and three 64 x 64 x windows
//   starting at rows t0 - 1, t0 and t0 + 1 (one box per tap, since a
//   one-row shift breaks the 8-row swizzle atom; L2 serves the repeats),
//   completed through mbarriers.  Warpgroups 1 and 2 (setmaxnreg 232)
//   each own 64 Cout rows x 64 Cin x 3 taps of f32 accumulators and run
//   wgmma m64n64k16 on both operands MN-major (the descriptors' transpose
//   bits), one dy tile feeding three products.  x is read through a 3-D
//   (Cin, T, B) tensor map, which zero-fills t = -1 and t >= T; rows with
//   n_b <= t < T are zeroed in shared memory by the consumers, only in the
//   tile that straddles n_b, and tiles whose window starts past n_b are
//   skipped.  TMA needs row strides in multiples of 16 bytes: the train
//   step's first Block1D (Cin 242, 484-byte rows) loads x by 4-byte
//   cp.async into the same swizzled layout instead (zeros for padding);
//   its three other shapes (Cin 1024 at T 512, Cin 512 and 1024 at T 256)
//   load x by TMA; dy (Cout 512) always takes TMA.
//   The split of the time tiles fills the card (ops/block1d_cuda.py
//   k7_plan).  Each CTA stages its sums in the ring, laid out as dW is,
//   and adds each Cout row (64 Cin x 3 taps, 768 contiguous bytes) to dW
//   with one bulk f32 reduction in L2 (cp.reduce.async.bulk); where Cin
//   is not a multiple of 4 or the Cin tile is partial, with coalesced
//   f32 atomics, in place of 24,576 scattered atomics a CTA.
//   Bound at (16, 512, 1024 -> 512): 25.8 GFLOP, 26 us at 989 TFLOP/s
//   against 31 MB (9 us): operations; the kernel takes 68 us there, where
//   cuDNN's conv1d weight gradient takes 101 us (NVIDIA H100 80GB HBM3,
//   700 W).
//
// Atomics make the order of the sums over blocks change from run to run.
// Not yet used in K6 and K7: a persistent grid, a cluster multicast of
// the dy tile or of K6's weight, the descriptors' base offset in place of
// three boxes a tap, a TMA store of K6's dx.
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using serenade::from_f;
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
    // all of this thread's rows are loaded before any is used: one trip
    // to memory's latency a tile, not one a row
    float yv[BM / 4], gv[BM / 4];
#pragma unroll
    for (int k = 0; k < BM / 4; ++k) {
      const int t = t0 + rs + 4 * k;
      const size_t idx = ((size_t)b * Tlen + t) * Cout + co;
      yv[k] = t < n ? y[idx] : 0.f;
      gv[k] = t < n ? to_f(g[idx]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < BM / 4; ++k) {
      if (t0 + rs + 4 * k >= n) break;
      float yhat, dz;
      mish_grad(yv[k], gv[k], mean, rstd, gam, bet, yhat, dz);
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
  }
  if (rs == 0) {
    const int gl = co / cg - g_first;
    if (cg % 32 == 0) {
      // a warp's 32 channels lie in one group: sum them in f64 across the
      // warp and add once (64 lanes adding to one shared f64 contend)
      double a = col ? (double)s1 : 0.0, c = col ? (double)s2 : 0.0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        c += __shfl_xor_sync(0xffffffffu, c, off);
      }
      if ((threadIdx.x & 31) == 0 && col) {
        atomicAdd(&gred[gl][0], a);
        atomicAdd(&gred[gl][1], c);
      }
    } else if (col) {
      atomicAdd(&gred[gl][0], (double)s1);
      atomicAdd(&gred[gl][1], (double)s2);
    }
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
    // all of this thread's rows are loaded before any is used
    float yv[BM / 4], gv[BM / 4];
#pragma unroll
    for (int k = 0; k < BM / 4; ++k) {
      const int t = t0 + rs + 4 * k;
      const size_t idx = ((size_t)b * Tlen + t) * Cout + co;
      yv[k] = t < n ? y[idx] : 0.f;
      gv[k] = t < n ? to_f(g[idx]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < BM / 4; ++k) {
      const int t = t0 + rs + 4 * k;
      if (t >= Tlen) break;
      float d = 0.f;
      if (t < n) {
        float yhat, dz;
        mish_grad(yv[k], gv[k], mean, rstd, gam, bet, yhat, dz);
        d = rstd * (dz * gam - a1 - yhat * a2);
      }
      dy[((size_t)b * Tlen + t) * Cout + co] = from_f<T>(d);
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

// bf16 on Hopper: one CTA of 384 threads per (128 time rows x BN input
// channels) tile of dx, BN 256 or 128 (ops/block1d_cuda.py k6_plan).
// The reduction runs over (dy channel chunk, tap) steps: each stage holds
// one tap's 128-row dy box, starting at row t0 - 1 + j (one box a tap,
// since a one-row shift breaks the 8-row swizzle atom; L2 serves the
// repeats), and tap 2 - j of K2's taps as BN / 64 boxes of 64 Cout rows
// x 64 Cin values (128 bytes a row, Cin contiguous).  Warpgroup 0 keeps
// the ring full by TMA; warpgroups 1 and 2 (setmaxnreg 232) each own 64
// rows x BN columns (BN / 2 f32 registers a thread) and run wgmma
// m64nBNk16, A (dy) K-major and B (the taps) MN-major, one group in
// flight while the next stage is waited for.
namespace k6 {

constexpr int BM = 128;            // time rows a CTA: 64 a consumer
constexpr int KC = 64;             // dy channels a stage (128 bytes)
constexpr int THREADS = 384;
constexpr int ABOX = BM * 128;     // one tap's dy box, bytes
constexpr int WBOX = 64 * 128;    // 64 Cin x 64 Cout of one tap, bytes
constexpr int MAX_STAGES = 8;

__host__ __device__ constexpr int stage_bytes(int bn) {
  return ABOX + bn * 128;
}

template <int BN>
__device__ __forceinline__ void mma(float (&acc)[BN / 2], uint64_t da,
                                    uint64_t db);
template <>
__device__ __forceinline__ void mma<256>(float (&acc)[128], uint64_t da,
                                         uint64_t db) {
  hopper::wgmma_m64n256k16_ss<0, 1>(acc, da, db, 1);
}
template <>
__device__ __forceinline__ void mma<128>(float (&acc)[64], uint64_t da,
                                         uint64_t db) {
  hopper::wgmma_m64n128k16_ss<0, 1>(acc, da, db, 1);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
dx_bf16_kernel(const __grid_constant__ CUtensorMap dy_map,
               const __grid_constant__ CUtensorMap w_map,
               const int* __restrict__ lengths, bf16* __restrict__ dx,
               int Tlen, int Cin, int Cout, int stages) {
  constexpr int SB = stage_bytes(BN);
  static_assert(2 * 64 * (BN * 2 + 16) <= 2 * SB,
                "the epilogue's staged tiles fit in a two-stage ring");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int t0 = blockIdx.x * BM, o0 = blockIdx.y * BN, b = blockIdx.z;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n = lengths[b];
  // dx rows at or past n are 0: a tile that lies wholly there stores
  // zeros and skips its products
  const bool active = t0 < n;
  const int steps = 3 * ((Cout + KC - 1) / KC);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight.  dy rows
    // n <= t < T are 0 in memory (gn_dy writes them) and the map
    // zero-fills t = -1 and t >= T, so A needs no masking ----
    hopper::setmaxnreg_dec<40>();
    if (tid == 0 && active) {
      int s = 0, ph = 0;
      for (int i = 0; i < steps; ++i) {
        const int c = i / 3, j = i - 3 * c;
        uint8_t* st = ring + s * SB;
        hopper::mbar_wait(&empty[s], ph ^ 1);
        hopper::mbar_expect_tx(&full[s], SB);
        hopper::tma_load_3d(st, &dy_map, &full[s], c * KC, t0 - 1 + j, b);
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          hopper::tma_load_3d(st + ABOX + q * WBOX, &w_map, &full[s],
                              o0 + 64 * q, c * KC, 2 - j);
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows t0 + 64 cw .. + 63 ----
  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;
  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  if (active) {
    int s = 0, ph = 0, prev = -1;
    for (int i = 0; i < steps; ++i) {
      uint8_t* st = ring + s * SB;
      hopper::mbar_wait(&full[s], ph);
      const uint32_t a = hopper::smem_addr(st) + cw * 64 * 128;
      const uint32_t w = hopper::smem_addr(st + ABOX);
      hopper::wgmma_fence();
      hopper::fence_regs(acc);
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks)
        mma<BN>(acc, hopper::desc_sw128(a + 32 * ks, 16, 1024),
                hopper::desc_sw128(w + 2048 * ks, WBOX, 1024));
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
      if (prev >= 0) {
        hopper::wgmma_wait<1>();   // the previous stage's products are done
        if (tid == 0) hopper::mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
  }

  // epilogue: rows past n get 0; element e is row 16 w + g + 8 ((e >> 1)
  // & 1), column 8 (e >> 2) + 2 t + (e & 1) of this consumer's 64 x BN
  // tile; Cin is even, so a pair of columns is in or out together
  const int w = tid / 32, g = (tid % 32) / 4, t4 = tid % 4;
  if (Cin % 8 == 0) {
    // through shared memory (the ring, once both consumers are done with
    // it), rows padded by 16 bytes so that a store's 32 lanes take 32
    // banks, then 16 bytes a thread along each row of dx
    constexpr int LD = BN * 2 + 16;
    hopper::named_barrier(1, 256);
    uint8_t* stage = ring + cw * 64 * LD;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * w + g + 8 * h;
      const bool keep = t0 + 64 * cw + r < n;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
        *reinterpret_cast<uint32_t*>(stage + r * LD + 2 * (8 * i + 2 * t4)) =
            serenade::pack_bf16(keep ? acc[4 * i + 2 * h] : 0.f,
                                keep ? acc[4 * i + 2 * h + 1] : 0.f);
    }
    hopper::named_barrier(2 + cw, 128);
    for (int c = tid; c < 64 * (BN / 8); c += 128) {
      const int r = c / (BN / 8), ch = c % (BN / 8);
      const int t = t0 + 64 * cw + r, o = o0 + 8 * ch;
      if (t < Tlen && o < Cin)
        *reinterpret_cast<uint4*>(dx + ((size_t)b * Tlen + t) * Cin + o) =
            *reinterpret_cast<const uint4*>(stage + r * LD + 16 * ch);
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + 64 * cw + 16 * w + g + 8 * h;
    if (t >= Tlen) continue;
    const bool keep = t < n;
    bf16* row = dx + ((size_t)b * Tlen + t) * Cin;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int o = o0 + 8 * i + 2 * t4;
      if (o < Cin)
        *reinterpret_cast<uint32_t*>(row + o) = serenade::pack_bf16(
            keep ? acc[4 * i + 2 * h] : 0.f,
            keep ? acc[4 * i + 2 * h + 1] : 0.f);
    }
  }
}

template <int BN>
int launch(const CUtensorMap& dy_map, const CUtensorMap& w_map,
           const int* lengths, bf16* dx, int B, int Tlen, int Cin, int Cout,
           int grid_x, int grid_y, int stages, int smem,
           cudaStream_t stream) {
  const cudaError_t a = cudaFuncSetAttribute(
      dx_bf16_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (a != cudaSuccess) return (int)a;
  dx_bf16_kernel<BN><<<dim3(grid_x, grid_y, B), THREADS, smem, stream>>>(
      dy_map, w_map, lengths, dx, Tlen, Cin, Cout, stages);
  return (int)cudaGetLastError();
}

}  // namespace k6

// ---------------------------------------------------------------------------
// K7: dW[co, ci, j] = sum over (b, t) of xm[t - 1 + j, ci] dy[t, co]
// ---------------------------------------------------------------------------

// The split of the time reduction, as the caller planned it
// (ops/block1d_cuda.py k7_plan): split z takes the 64-row time tiles
// [first[z], first[z + 1]); tile i is sample i / tps, rows 64 (i % tps) ..
// Passed by value, read in parameter space.
constexpr int MAX_SPLITS = 512;
struct Splits {
  int first[MAX_SPLITS + 1];
};

__device__ __forceinline__ void add_dw(float* dw, int co, int ci, int j,
                                       int Cin, int Cout, float v) {
  if (co < Cout && ci < Cin)
    atomicAdd(&dw[((size_t)co * Cin + ci) * 3 + j], v);
}

// f32: 256 threads, each 4 Cout x 4 Cin x 3 taps
__global__ void __launch_bounds__(THREADS)
dw_f32_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
              const float* __restrict__ dy, float* __restrict__ dw,
              int Tlen, int Cin, int Cout,
              const __grid_constant__ Splits splits) {
  __shared__ __align__(16) float dys[BM][BN];       // [t][co]
  __shared__ __align__(16) float xw[BM + 2][BN];    // [window row][ci]
  const int co0 = blockIdx.x * BN, ci0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tps = (Tlen + BM - 1) / BM;
  const int first = splits.first[blockIdx.z];
  const int last = splits.first[blockIdx.z + 1];
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

// bf16 on Hopper: one CTA per (128 Cout x 64 Cin) tile and split of the
// 64-row time tiles; warpgroup 0 loads, warpgroups 1 and 2 each own 64 Cout
// rows x 64 Cin x 3 taps of f32 accumulators (96 registers a thread) and
// run wgmma m64n64k16 with A = dy [t][co] and B = the x window [t][ci],
// both MN-major, so nothing is transposed in software.
namespace k7 {

constexpr int BT = 64;          // time rows a stage (the reduction)
constexpr int BCO = 128;        // Cout a CTA: 64 a consumer warpgroup
constexpr int BCI = 64;         // Cin a CTA
constexpr int STAGES = 4;
constexpr int BOX = 64 * 128;   // one 64-row x 64-element bf16 box, bytes
constexpr int STAGE = 5 * BOX;  // dy for both consumers, x for 3 taps
constexpr int SMEM = STAGES * STAGE + 1024;   // + alignment of the ring
constexpr int OUT_LD = 3 * BCI + 4;   // floats a row of the staged sums
static_assert(BCO * OUT_LD * 4 <= STAGES * STAGE, "sums fit in the ring");
constexpr int THREADS = 384;

// the time tiles [first, last) of this CTA's split; a tile whose window
// starts at or past the sample's last valid row adds nothing and is
// skipped by both roles
struct Tiles {
  int first, last, tps;
  __device__ Tiles(int T, const Splits& splits)
      : first(splits.first[blockIdx.z]),
        last(splits.first[blockIdx.z + 1]),
        tps((T + BT - 1) / BT) {}
};

__global__ void __launch_bounds__(THREADS, 1)
dw_bf16_kernel(const __grid_constant__ CUtensorMap dy_map,
               const __grid_constant__ CUtensorMap x_map,
               const bf16* __restrict__ x, const int* __restrict__ lengths,
               float* __restrict__ dw, int Tlen, int Cin, int Cout,
               const __grid_constant__ Splits splits, int x_by_tma) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int co0 = blockIdx.x * BCO, ci0 = blockIdx.y * BCI;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const Tiles tiles(Tlen, splits);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // TMA: one arrival with the bytes; cp.async: and one when the
      // producer's copies of the stage have landed
      hopper::mbar_init(&full[s], x_by_tma ? 1 : 2);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    hopper::setmaxnreg_dec<40>();
    int s = 0, ph = 0, prev = -1;
    for (int i = tiles.first; i < tiles.last; ++i) {
      const int b = i / tiles.tps, t0 = (i % tiles.tps) * BT;
      const int n = lengths[b];
      if (t0 - 1 >= n) continue;
      uint8_t* st = ring + s * STAGE;
      if (x_by_tma) {
        if (tid == 0) {
          hopper::mbar_wait(&empty[s], ph ^ 1);
          hopper::mbar_expect_tx(&full[s], STAGE);
          hopper::tma_load_3d(st, &dy_map, &full[s], co0, t0, b);
          hopper::tma_load_3d(st + BOX, &dy_map, &full[s], co0 + 64, t0, b);
          for (int j = 0; j < 3; ++j)
            hopper::tma_load_3d(st + (2 + j) * BOX, &x_map, &full[s], ci0,
                                t0 - 1 + j, b);
        }
      } else {
        // Cin rows that TMA cannot take (row stride not a multiple of 16
        // bytes): 4-byte cp.async into the same swizzled layout, rows
        // outside [0, n) and channels past Cin written as zeros
        hopper::mbar_wait(&empty[s], ph ^ 1);
        if (tid == 0) {
          hopper::mbar_expect_tx(&full[s], 2 * BOX);
          hopper::tma_load_3d(st, &dy_map, &full[s], co0, t0, b);
          hopper::tma_load_3d(st + BOX, &dy_map, &full[s], co0 + 64, t0, b);
        }
        const bf16* xb = x + (size_t)b * Tlen * Cin;
        for (int e = tid; e < 3 * BT * 32; e += 128) {
          const int j = e / (BT * 32), r = (e / 32) % BT, p = e % 32;
          const int t = t0 - 1 + j + r, ci = ci0 + 2 * p;
          const bool ok = t >= 0 && t < n && ci < Cin;
          const bf16* src = ok ? xb + (size_t)t * Cin + ci : x;
          hopper::cp_async_4(st + (2 + j) * BOX + hopper::sw128(r, 4 * p),
                             src, ok);
        }
        hopper::cp_async_commit();
        if (prev >= 0) {
          hopper::cp_async_wait<1>();   // the previous stage has landed
          hopper::fence_async_shared();
          hopper::named_barrier(1, 128);
          if (tid == 0) hopper::mbar_arrive(&full[prev]);
        }
        prev = s;
      }
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    if (!x_by_tma && prev >= 0) {
      hopper::cp_async_wait<0>();
      hopper::fence_async_shared();
      hopper::named_barrier(1, 128);
      if (tid == 0) hopper::mbar_arrive(&full[prev]);
    }
  } else {
    // ---- consumers ----
    hopper::setmaxnreg_inc<232>();
    const int cw = wg - 1;
    float acc[3][32];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
    int s = 0, ph = 0, prev = -1;
    for (int i = tiles.first; i < tiles.last; ++i) {
      const int b = i / tiles.tps, t0 = (i % tiles.tps) * BT;
      const int n = lengths[b];
      if (t0 - 1 >= n) continue;
      uint8_t* st = ring + s * STAGE;
      hopper::mbar_wait(&full[s], ph);
      if (t0 + BT >= n) {
        // x rows at or past n are not zero in memory: zero them here (a
        // whole 128-byte row, so the swizzle does not matter), each
        // consumer half of the 3 x 64 rows; both wait for all the zeros
        // before either product reads the boxes
        for (int e = 128 * cw + tid; e < 3 * BT * 8; e += 256) {
          const int j = e / (BT * 8), r = (e / 8) % BT, c = e % 8;
          if (t0 - 1 + j + r >= n)
            *reinterpret_cast<uint4*>(st + (2 + j) * BOX + r * 128 + 16 * c) =
                make_uint4(0u, 0u, 0u, 0u);
        }
        hopper::fence_async_shared();
        hopper::named_barrier(2, 256);
      }
      const uint32_t a0 = hopper::smem_addr(st + cw * BOX);
      const uint32_t b0 = hopper::smem_addr(st + 2 * BOX);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 3; ++j) hopper::fence_regs(acc[j]);
#pragma unroll
      for (int ks = 0; ks < BT / 16; ++ks) {
        const uint64_t da = hopper::desc_sw128(a0 + ks * 2048, BOX, 1024);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          hopper::wgmma_m64n64k16_ss<1, 1>(
              acc[j], da,
              hopper::desc_sw128(b0 + j * BOX + ks * 2048, BOX, 1024), 1);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int j = 0; j < 3; ++j) hopper::fence_regs(acc[j]);
      if (prev >= 0) {
        hopper::wgmma_wait<1>();   // the previous stage's products are done
        if (tid == 0) hopper::mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 3; ++j) hopper::fence_regs(acc[j]);
    // The CTA's sums go to dW (Cout, Cin, 3) through shared memory, laid
    // out as dW is: row co holds ci0 .. ci0 + 63 x 3 taps, 768 contiguous
    // bytes of dW.  Both consumers must be done with the ring first.
    hopper::named_barrier(3, 256);
    float* out = reinterpret_cast<float*>(ring);
    // element e of a tap's m64n64 accumulator: Cout row 16 w + g + 8
    // ((e >> 1) & 1), Cin column 8 (e >> 2) + 2 t + (e & 1)
    const int w = tid / 32, g = (tid % 32) / 4, t4 = tid % 4;
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e)
        out[(64 * cw + 16 * w + g + 8 * ((e >> 1) & 1)) * OUT_LD +
            3 * (8 * (e >> 2) + 2 * t4 + (e & 1)) + j] = acc[j][e];
    hopper::fence_async_shared();
    hopper::named_barrier(3, 256);
    const int rows = min(BCO, Cout - co0), cols = 3 * min(BCI, Cin - ci0);
    const int r0 = 64 * cw;   // this consumer's rows
    if (Cin % 4 == 0 && cols == 3 * BCI) {
      // one bulk reduction (f32 add in L2) per row: 16-byte aligned since
      // Cin % 4 == 0 and ci0 % 64 == 0
      if (tid < 64 && r0 + tid < rows) {
        const int r = r0 + tid;
        hopper::bulk_reduce_add_f32(
            dw + ((size_t)(co0 + r) * Cin + ci0) * 3, out + r * OUT_LD,
            3 * BCI * 4);
        hopper::bulk_commit();
        hopper::bulk_wait_read();
      }
    } else {
      // coalesced atomics: neighbouring threads add neighbouring floats
      for (int r = r0; r < min(r0 + 64, rows); ++r)
        for (int c = tid; c < cols; c += 128)
          atomicAdd(&dw[((size_t)(co0 + r) * Cin + ci0) * 3 + c],
                    out[r * OUT_LD + c]);
    }
  }
}

}  // namespace k7

}  // namespace

// dparams (3, Cout) f32, zeroed: dgamma, dbeta, dbias; gsum (B, G, 2) f64,
// zeroed: the group sums of dyhat and dyhat yhat.  The caller plans the dx
// launch (ops/block1d_cuda.py k6_plan) and this entry checks the plan
// against the kernels' constants before anything runs: bf16 takes `bn`
// input channels a CTA (256 or 128), the grid (128-row tiles, Cin tiles),
// the ring's stages and the dynamic shared memory, and reads `w_taps`
// (3, Cout, Cin8), k2_taps of the weight; f32 reads `w` (Cout, Cin, 3),
// runs 64 x 64 FMA tiles and takes bn = stages = smem = 0.  A plan that
// does not match returns cudaErrorInvalidValue.
extern "C" int serenade_block1d_bwd_data(
    const int* lengths, const void* w, const void* w_taps, const float* y,
    const double* stats, const float* gamma, const float* beta, const void* g,
    double* gsum, void* dx, void* dy, float* dparams, int B, int Tlen,
    int Cin, int Cout, int G, float eps, int bn, int grid_x, int grid_y,
    int stages, int smem, int dtype, cudaStream_t stream) {
  if (B <= 0 || Tlen <= 0 || Cin <= 0 || Cout <= 0 || Cout % G != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 gn_grid((Tlen + BM - 1) / BM, (Cout + BN - 1) / BN, B);
  CUtensorMap dy_map, w_map;
  if (dtype == 1) {
    if ((bn != 128 && bn != 256) || Cin % 2 != 0 || Cout % 8 != 0 ||
        grid_x != (Tlen + k6::BM - 1) / k6::BM ||
        grid_y != (Cin + bn - 1) / bn || stages < 2 ||
        stages > k6::MAX_STAGES ||
        smem != stages * k6::stage_bytes(bn) + 1024)
      return (int)cudaErrorInvalidValue;
    // dy as (Cout, T, B) in boxes of 64 channels x 128 rows; the taps as
    // (Cin8, Cout, 3) in boxes of 64 Cin x 64 Cout
    const int cin8 = (Cin + 7) / 8 * 8;
    const cuuint64_t dims[3] = {(cuuint64_t)Cout, (cuuint64_t)Tlen,
                                (cuuint64_t)B};
    const cuuint64_t strides[2] = {2ull * Cout, 2ull * Cout * Tlen};
    const cuuint32_t box[3] = {64, (cuuint32_t)k6::BM, 1};
    int e = hopper::encode_map_bf16(&dy_map, dy, 3, dims, strides, box);
    if (e) return e;
    const cuuint64_t wdims[3] = {(cuuint64_t)cin8, (cuuint64_t)Cout, 3};
    const cuuint64_t wstrides[2] = {2ull * cin8, 2ull * cin8 * Cout};
    const cuuint32_t wbox[3] = {64, 64, 1};
    e = hopper::encode_map_bf16(&w_map, w_taps, 3, wdims, wstrides, wbox);
    if (e) return e;
  } else if (dtype == 0) {
    if (bn || stages || smem || grid_x != (Tlen + BM - 1) / BM ||
        grid_y != (Cin + BN - 1) / BN)
      return (int)cudaErrorInvalidValue;
  }
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
  });
  if (dtype == 1) {
    return bn == 256
               ? k6::launch<256>(dy_map, w_map, lengths,
                                 static_cast<bf16*>(dx), B, Tlen, Cin, Cout,
                                 grid_x, grid_y, stages, smem, stream)
               : k6::launch<128>(dy_map, w_map, lengths,
                                 static_cast<bf16*>(dx), B, Tlen, Cin, Cout,
                                 grid_x, grid_y, stages, smem, stream);
  }
  dx_f32_kernel<<<dim3(grid_x, grid_y, B), THREADS, 0, stream>>>(
      static_cast<const float*>(dy), lengths, static_cast<const float*>(w),
      static_cast<float*>(dx), Tlen, Cin, Cout);
  return (int)cudaGetLastError();
}

// dw (Cout, Cin, 3) f32, zeroed.  The caller plans the launch
// (ops/block1d_cuda.py k7_plan) and this entry checks the plan against the
// kernels' own tiles and shared memory: grid (grid_x, grid_y, splits),
// `first` the splits + 1 bounds of the time tiles, `smem` the dynamic
// shared memory and `x_by_tma` x's loader.  bf16 runs the Hopper kernel on
// (128 Cout x 64 Cin) tiles, x by TMA (Cin % 8 == 0) or by cp.async (Cin
// even); f32 runs (64 x 64) tiles on FMA units, with no shared memory
// beyond its static arrays.  A plan that does not match returns
// cudaErrorInvalidValue.
extern "C" int serenade_block1d_bwd_weight(
    const void* x, const int* lengths, const void* dy, float* dw, int B,
    int Tlen, int Cin, int Cout, int grid_x, int grid_y, int splits,
    const int* first, int smem, int x_by_tma, int dtype,
    cudaStream_t stream) {
  if (B <= 0 || Tlen <= 0 || Cin <= 0 || Cout <= 0 || splits <= 0 ||
      splits > MAX_SPLITS || first[0] != 0 ||
      first[splits] != B * ((Tlen + BM - 1) / BM))
    return (int)cudaErrorInvalidValue;
  Splits sp;
  for (int z = 0; z <= splits; ++z) {
    if (z > 0 && first[z] < first[z - 1]) return (int)cudaErrorInvalidValue;
    sp.first[z] = first[z];
  }
  if (dtype == 1) {
    static_assert(k7::BT == BM, "both kernels split 64-row time tiles");
    if (Cin % 2 != 0 || Cout % 8 != 0 || (x_by_tma && Cin % 8 != 0) ||
        grid_x != (Cout + k7::BCO - 1) / k7::BCO ||
        grid_y != (Cin + k7::BCI - 1) / k7::BCI || smem != k7::SMEM)
      return (int)cudaErrorInvalidValue;
    // (C, T, B) maps, innermost first; boxes of 64 channels x 64 rows
    CUtensorMap dy_map, x_map;
    memset(&x_map, 0, sizeof(x_map));
    const cuuint32_t box[3] = {64, 64, 1};
    const cuuint64_t dy_dims[3] = {(cuuint64_t)Cout, (cuuint64_t)Tlen,
                                   (cuuint64_t)B};
    const cuuint64_t dy_strides[2] = {2ull * Cout, 2ull * Cout * Tlen};
    int e = hopper::encode_map_bf16(&dy_map, dy, 3, dy_dims, dy_strides, box);
    if (e) return e;
    if (x_by_tma) {
      const cuuint64_t x_dims[3] = {(cuuint64_t)Cin, (cuuint64_t)Tlen,
                                    (cuuint64_t)B};
      const cuuint64_t x_strides[2] = {2ull * Cin, 2ull * Cin * Tlen};
      e = hopper::encode_map_bf16(&x_map, x, 3, x_dims, x_strides, box);
      if (e) return e;
    }
    const cudaError_t a = cudaFuncSetAttribute(
        k7::dw_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (a != cudaSuccess) return (int)a;
    k7::dw_bf16_kernel<<<dim3(grid_x, grid_y, splits), k7::THREADS, smem,
                         stream>>>(dy_map, x_map, static_cast<const bf16*>(x),
                                   lengths, dw, Tlen, Cin, Cout, sp,
                                   x_by_tma);
  } else if (dtype == 0) {
    if (x_by_tma || smem != 0 || grid_x != (Cout + BN - 1) / BN ||
        grid_y != (Cin + BN - 1) / BN)
      return (int)cudaErrorInvalidValue;
    dw_f32_kernel<<<dim3(grid_x, grid_y, splits), THREADS, 0, stream>>>(
        static_cast<const float*>(x), lengths, static_cast<const float*>(dy),
        dw, Tlen, Cin, Cout, sp);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
