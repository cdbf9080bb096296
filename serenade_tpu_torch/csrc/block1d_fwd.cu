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
// Design: two kernels.  (1) conv + bias + statistics: writes conv + bias
// to an f32 scratch y (K6 reads it in training) and adds each group's sum
// and sum of squares over valid rows into f64 statistics (shared-memory
// then global atomics; f64 keeps the single-pass variance E[y^2] - mu^2
// close to the two-pass one).  (2) norm_mish: an elementwise pass that
// normalizes, applies the f32 affine, a single-exponential Mish and the
// mask.  Any Cin works (the TPU gate cin % 128 does not apply).
//   bf16 (the serving and training path), designed for Hopper: a CTA of
//   384 threads per 64 time rows x 2 WN output channels (WN 64 or 32,
//   chosen by ops/block1d_cuda.py k2_plan so that batch 1 spreads over
//   the SMs: T 1536 x Cout 512 gives 96 CTAs, T 768 gives 96 of 64 x 64).
//   Warpgroup 0 keeps a ring of stages full, a stage being 64 input
//   channels: the x window as three 64-row boxes starting at rows t0 - 1,
//   t0 and t0 + 1 (one box a tap, since a one-row shift breaks the 8-row
//   swizzle atom; L2 serves the repeats) and each tap's weight, laid out
//   once per weight version as (3, Cout, Cin) with Cin contiguous.  x
//   comes through a 3-D (Cin, T, B) tensor map that zero-fills t = -1 and
//   t >= T; rows n <= t < T are zeroed in shared memory, only in the tile
//   whose window reaches n.  Cin 242 (484-byte rows, which TMA cannot
//   take) loads x by 4-byte cp.async into the same swizzled layout, zeros
//   for padding.  Warpgroups 1 and 2 (setmaxnreg 232) each own WN columns
//   and run wgmma m64nWNk16 with both operands K-major, the three taps
//   summing into one accumulator; the epilogue adds the bias, stores y and
//   reduces the group sums over its 64 rows.  No split of the 3 Cin
//   depth: the statistics need whole conv outputs, and a split would add
//   a pass over y.
//   f32 (parity checks): one block per (64 rows x 64 channels) tile loops
//   over Cin in chunks of 16, staging the masked input window (66 rows,
//   zeros outside [0, n)) and the three taps of the weight chunk; 256
//   threads accumulate 4 x 4 tiles on FMA units (6 input reads serve all 3
//   taps).
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using serenade::from_f;
using serenade::to_f;
using bf16 = __nv_bfloat16;

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

// bf16 on Hopper: one CTA of 384 threads per (64 time rows x 2 WN output
// channels) tile; warpgroup 0 loads a ring of stages, one stage a chunk
// of 64 input channels: the x window for the three taps (three 64-row
// boxes starting at rows t0 - 1, t0 and t0 + 1, since a one-row shift
// breaks the 8-row swizzle atom) and the weight of each tap (2 WN rows of
// Cout, Cin contiguous).  Warpgroups 1 and 2 each own WN columns and run
// wgmma m64nWNk16 with both operands K-major, the three taps summing
// into one accumulator.
namespace k2 {

constexpr int BM = 64;               // time rows a CTA
constexpr int KC = 64;               // input channels a stage (128 bytes)
constexpr int THREADS = 384;
constexpr int XBOX = BM * 128;       // one tap's x box, bytes
constexpr int MAX_STAGES = 6;
// the cp.async producer completes stage c - 1 only after it has waited for
// stage c's slot, which the consumers free only after stage c - 1: two
// stages would wait on each other
constexpr int MIN_STAGES_CP_ASYNC = 3;

__host__ __device__ constexpr int stage_bytes(int wn) {
  return 3 * XBOX + 3 * 2 * wn * 128;
}

template <int WN>
__device__ __forceinline__ void mma(float (&acc)[WN / 2], uint64_t da,
                                    uint64_t db);
template <>
__device__ __forceinline__ void mma<64>(float (&acc)[32], uint64_t da,
                                        uint64_t db) {
  hopper::wgmma_m64n64k16_ss<0, 0>(acc, da, db, 1);
}
template <>
__device__ __forceinline__ void mma<32>(float (&acc)[16], uint64_t da,
                                        uint64_t db) {
  hopper::wgmma_m64n32k16_ss<0, 0>(acc, da, db, 1);
}

template <int WN>
__global__ void __launch_bounds__(THREADS, 1)
conv_stats_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map,
                  const bf16* __restrict__ x, const int* __restrict__ lengths,
                  const float* __restrict__ bias, float* __restrict__ y,
                  double* __restrict__ stats, int Tlen, int Cin, int Cout,
                  int G, int stages, int x_by_tma) {
  constexpr int BN = 2 * WN;
  constexpr int SB = stage_bytes(WN);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ double red[BN][2];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int t0 = blockIdx.x * BM, co0 = blockIdx.y * BN, b = blockIdx.z;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n = lengths[b];
  const int chunks = (Cin + KC - 1) / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // TMA: one arrival with the bytes; cp.async: and one when the
      // producer's copies of the stage have landed
      hopper::mbar_init(&full[s], x_by_tma ? 1 : 2);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::mbar_fence_init();
  }
  for (int i = threadIdx.x; i < BN * 2; i += THREADS) (&red[0][0])[i] = 0.0;
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    hopper::setmaxnreg_dec<40>();
    int s = 0, ph = 0, prev = -1;
    for (int c = 0; c < chunks; ++c) {
      uint8_t* st = ring + s * SB;
      const int ci0 = c * KC;
      if (x_by_tma) {
        if (tid == 0) {
          hopper::mbar_wait(&empty[s], ph ^ 1);
          hopper::mbar_expect_tx(&full[s], SB);
          for (int j = 0; j < 3; ++j) {
            hopper::tma_load_3d(st + j * XBOX, &x_map, &full[s], ci0,
                                t0 - 1 + j, b);
            hopper::tma_load_3d(st + 3 * XBOX + j * BN * 128, &w_map,
                                &full[s], ci0, co0, j);
          }
        }
      } else {
        // Cin rows that TMA cannot take (row stride not a multiple of 16
        // bytes): 4-byte cp.async into the same swizzled layout, rows
        // outside [0, n) and channels past Cin written as zeros
        hopper::mbar_wait(&empty[s], ph ^ 1);
        if (tid == 0) {
          hopper::mbar_expect_tx(&full[s], 3 * BN * 128);
          for (int j = 0; j < 3; ++j)
            hopper::tma_load_3d(st + 3 * XBOX + j * BN * 128, &w_map,
                                &full[s], ci0, co0, j);
        }
        const bf16* xb = x + (size_t)b * Tlen * Cin;
        for (int e = tid; e < 3 * BM * 32; e += 128) {
          const int j = e / (BM * 32), r = (e / 32) % BM, p = e % 32;
          const int t = t0 - 1 + j + r, ci = ci0 + 2 * p;
          const bool ok = t >= 0 && t < n && ci < Cin;
          const bf16* src = ok ? xb + (size_t)t * Cin + ci : x;
          hopper::cp_async_4(st + j * XBOX + hopper::sw128(r, 4 * p), src,
                             ok);
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
      if (++s == stages) {
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
    return;
  }

  // ---- consumers ----
  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;
  float acc[WN / 2];
#pragma unroll
  for (int e = 0; e < WN / 2; ++e) acc[e] = 0.f;
  // x rows at or past n are not zero in memory: the tile whose window
  // reaches n zeroes them in every stage (TMA zero-fills t = -1, t >= T)
  const bool straddles = x_by_tma && t0 + BM + 1 > n;
  int s = 0, ph = 0, prev = -1;
  for (int c = 0; c < chunks; ++c) {
    uint8_t* st = ring + s * SB;
    hopper::mbar_wait(&full[s], ph);
    if (straddles) {
      // whole 128-byte rows, so the swizzle does not matter; each consumer
      // half of the 3 x 64 rows, and both wait for all the zeros
      for (int e = 128 * cw + tid; e < 3 * BM * 8; e += 256) {
        const int j = e / (BM * 8), r = (e / 8) % BM, q = e % 8;
        if (t0 - 1 + j + r >= n)
          *reinterpret_cast<uint4*>(st + j * XBOX + r * 128 + 16 * q) =
              make_uint4(0u, 0u, 0u, 0u);
      }
      hopper::fence_async_shared();
      hopper::named_barrier(2, 256);
    }
    const uint32_t xa = hopper::smem_addr(st);
    const uint32_t wa = hopper::smem_addr(st + 3 * XBOX) + cw * WN * 128;
    hopper::wgmma_fence();
    hopper::fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        mma<WN>(acc, hopper::desc_sw128(xa + j * XBOX + 32 * ks, 16, 1024),
                hopper::desc_sw128(wa + j * BN * 128 + 32 * ks, 16, 1024));
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

  // epilogue: + bias, store y, per-group sums over valid rows.  Element e
  // is row 16 w + g + 8 ((e >> 1) & 1), column 8 (e >> 2) + 2 t + (e & 1)
  // of this consumer's 64 x WN tile.
  const int w = tid / 32, g = (tid % 32) / 4, t4 = tid % 4;
  const int cg = Cout / G, g_first = co0 / cg;
#pragma unroll
  for (int i = 0; i < WN / 8; ++i) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int co = co0 + cw * WN + 8 * i + 2 * t4 + q;
      const bool col_ok = co < Cout;
      const float bc = col_ok ? bias[co] : 0.f;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + 16 * w + g + 8 * h;
        const float val = acc[4 * i + 2 * h + q] + bc;
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
  hopper::named_barrier(3, 256);
  const int c_last = min(co0 + BN, Cout) - 1;
  const int n_groups = c_last / cg - g_first + 1;
  const int i = 128 * cw + tid;
  if (i < 2 * n_groups) {
    const int gl = i >> 1, which = i & 1;
    atomicAdd(&stats[((size_t)b * G + g_first + gl) * 2 + which],
              red[gl][which]);
  }
}

template <int WN>
int launch(const CUtensorMap& x_map, const CUtensorMap& w_map, const bf16* x,
           const int* lengths, const float* bias, float* y, double* stats,
           int B, int Tlen, int Cin, int Cout, int G, int grid_x, int grid_y,
           int stages, int smem, int x_by_tma, cudaStream_t stream) {
  const cudaError_t a = cudaFuncSetAttribute(
      conv_stats_kernel<WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (a != cudaSuccess) return (int)a;
  conv_stats_kernel<WN><<<dim3(grid_x, grid_y, B), THREADS, smem, stream>>>(
      x_map, w_map, x, lengths, bias, y, stats, Tlen, Cin, Cout, G, stages,
      x_by_tma);
  return (int)cudaGetLastError();
}

}  // namespace k2

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

// y (B, T, Cout) f32 and stats (B, G, 2) f64, zeroed, then out.  The
// caller plans the bf16 launch (ops/block1d_cuda.py k2_plan): wn columns a
// consumer warpgroup (32 or 64), the grid (64-row tiles, Cout tiles of
// 2 wn), the ring's stages, the dynamic shared memory and x's loader
// (TMA when Cin % 8 == 0, else 4-byte cp.async); `w_taps` (3, Cout,
// Cin8) is its weight, Cin padded with zeros to a multiple of 8.  f32
// reads `w` (Cout, Cin, 3) and takes wn = stages = smem = 0.  A plan that
// does not match the kernels' constants returns cudaErrorInvalidValue.
extern "C" int serenade_block1d_fwd(
    const void* x, const int* lengths, const void* w, const void* w_taps,
    const float* bias, const float* gamma, const float* beta, float* y,
    double* stats, void* out, int B, int Tlen, int Cin, int Cout, int G,
    float eps, int wn, int grid_x, int grid_y, int stages, int smem,
    int x_by_tma, int dtype, cudaStream_t stream) {
  if (B <= 0 || Tlen <= 0 || Cin <= 0 || Cout % 4 != 0 || Cout % G != 0)
    return (int)cudaErrorInvalidValue;
  const long long total4 = (long long)B * Tlen * Cout / 4;
  const int nb = (int)((total4 + 255) / 256);
  if (dtype == 1) {
    const int cin8 = (Cin + 7) / 8 * 8;
    if ((wn != 32 && wn != 64) || Cin % 2 != 0 || (x_by_tma && Cin % 8) ||
        grid_x != (Tlen + k2::BM - 1) / k2::BM ||
        grid_y != (Cout + 2 * wn - 1) / (2 * wn) ||
        stages < (x_by_tma ? 2 : k2::MIN_STAGES_CP_ASYNC) ||
        stages > k2::MAX_STAGES ||
        smem != stages * k2::stage_bytes(wn) + 1024)
      return (int)cudaErrorInvalidValue;
    // x as (Cin, T, B) in boxes of 64 channels x 64 rows; the taps as
    // (Cin8, Cout, 3) in boxes of 64 channels x 2 wn rows
    CUtensorMap x_map, w_map;
    memset(&x_map, 0, sizeof(x_map));
    if (x_by_tma) {
      const cuuint64_t dims[3] = {(cuuint64_t)Cin, (cuuint64_t)Tlen,
                                  (cuuint64_t)B};
      const cuuint64_t strides[2] = {2ull * Cin, 2ull * Cin * Tlen};
      const cuuint32_t box[3] = {64, (cuuint32_t)k2::BM, 1};
      const int e = hopper::encode_map_bf16(&x_map, x, 3, dims, strides, box);
      if (e) return e;
    }
    const cuuint64_t wdims[3] = {(cuuint64_t)cin8, (cuuint64_t)Cout, 3};
    const cuuint64_t wstrides[2] = {2ull * cin8, 2ull * cin8 * Cout};
    const cuuint32_t wbox[3] = {64, (cuuint32_t)(2 * wn), 1};
    const int e = hopper::encode_map_bf16(&w_map, w_taps, 3, wdims, wstrides,
                                          wbox);
    if (e) return e;
    const int r =
        wn == 64
            ? k2::launch<64>(x_map, w_map, static_cast<const bf16*>(x),
                             lengths, bias, y, stats, B, Tlen, Cin, Cout, G,
                             grid_x, grid_y, stages, smem, x_by_tma, stream)
            : k2::launch<32>(x_map, w_map, static_cast<const bf16*>(x),
                             lengths, bias, y, stats, B, Tlen, Cin, Cout, G,
                             grid_x, grid_y, stages, smem, x_by_tma, stream);
    if (r) return r;
    norm_mish_kernel<bf16><<<nb, 256, 0, stream>>>(
        y, lengths, stats, gamma, beta, static_cast<bf16*>(out), Tlen, Cout,
        G, eps, total4);
  } else if (dtype == 0) {
    if (wn || stages || smem || x_by_tma ||
        grid_x != (Tlen + BM - 1) / BM || grid_y != (Cout + BN - 1) / BN)
      return (int)cudaErrorInvalidValue;
    conv_stats_kernel<float><<<dim3(grid_x, grid_y, B), THREADS, 0, stream>>>(
        static_cast<const float*>(x), lengths, static_cast<const float*>(w),
        bias, y, stats, Tlen, Cin, Cout, G);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    norm_mish_kernel<float><<<nb, 256, 0, stream>>>(
        y, lengths, stats, gamma, beta, static_cast<float*>(out), Tlen, Cout,
        G, eps, total4);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
