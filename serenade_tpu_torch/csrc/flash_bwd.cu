// K4 and K5: the flash-attention backward of the UNet self-attention.
//
// K4 replaces serenade_tpu/ops/flash_pallas.py:267 (_flash_backward ->
// _bwd_dq_kernel, :149) and K5 flash_pallas.py:291 (_bwd_dkv_kernel,
// :186).  Both recompute P = exp(S - L) from Q, K and the forward's f32
// row logsumexp L, with S = Q K^T * scale + key bias (-1e30 on padded
// keys, no weight on keys past Tk):
//   dP = dO V^T (f32),  dS = P o (dP - D) * scale,  D = rowsum(dO o O)
//   K4: dQ = dS K   (dS in the input type, f32 accumulation)
//   K5: dV = P^T dO (P and dO in f32),  dK = dS^T Q (dS in the input type)
// D comes from the wrapper (one PyTorch op, as JAX computes it outside the
// kernels).  There is no query mask: padded query rows get dQ from their
// dO, as in JAX.
//
// What bounds them on the H100: at the train-step shape (B 16, H 4,
// T 512, D 512, bf16) K4 does 6 B H T^2 D = 51.5 GFLOP and K5
// 8 B H T^2 D = 68.7 GFLOP against about 0.1 GB of inputs and outputs:
// operations bound both.  head_dim 512 is what shapes the design: one
// 64 x 512 f32 accumulator is 128 KB, more than one warp group can hold
// in registers, and the dK + dV accumulators of 64 keys (256 KB) exceed
// the 227 KB of shared memory.
//
// K4, bf16 (the training path): tensor cores through mma.sync m16n8k16
// with f32 accumulation, one block of 16 warps (512 threads, one block an
// SM).  A block owns 64 query rows of one (b, h) and keeps Q and dO for
// them in shared memory (133 KB at D 512); it loops over 32-key tiles of
// K and V (67 KB).  Phase 1: warp w computes the 16 x 8 patch (query rows
// 16 (w / 4), keys 8 (w % 4)) of both S and dP over the whole head dim,
// forms dS in registers and stores it as bf16 (JAX casts dS to K's type).
// Phase 2: warp w adds dS K for query rows 16 (w / 4) and a quarter of
// the head dim (D / 4 columns, 64 f32 accumulators a thread), reading K
// with ldmatrix.trans.  No product is computed twice.
//
// K5, bf16 (the training path), designed for Hopper; head_dim 512 only
// (ops/flash_cuda.py k5_plan raises on another).  One CTA of 384 threads
// per 32 keys of one (b, h): the dK + dV accumulators of 32 keys x 512
// columns in f32 take 128 KB, half the register file, and K, V (64 KB)
// plus one 64-query tile of Q and of dO (128 KB) leave no room in the
// 227 KB of shared memory for a second tile.  ptxas gives a 384-thread
// CTA 168 registers a thread whatever setmaxnreg asks, so the roles keep
// the 128 accumulator registers apart from everything else:
//   warpgroup 0 computes S = Q K^T and dP = dO V^T (wgmma m64n32k16 over
//   D 512, 64 queries x 32 keys each), P = exp(S scale + bias - L) and
//   dS = P (dP - D) scale, and writes dS and P (as bf16 hi + lo, since
//   JAX keeps P f32 for dV: 16 bits of mantissa, one more product) as
//   [key][query] rows of 64 bf16, one 128-byte swizzle row each: K-major
//   B operands.  Its thread 0 issues every TMA load, at points where no
//   product is in flight: K and V once, then each half (four 64-column
//   blocks) of the next Q and dO tiles as the last tile's products free
//   it, one instruction a half through 5-D tensor maps (64 columns, T,
//   column block, H, B) over the strided (B, H, T, D) views;
//   warpgroups 1 and 2 accumulate dK^T += Q^T dS and dV^T += dO^T P
//   (M = head dim, eight m64 tiles; N = 32 keys; A read MN-major from the
//   TMA tiles through the descriptors' transpose bit), 512 x 32 in 128
//   registers a thread, and free each half of their tile as its four m64
//   tiles finish.
// No product is computed twice, and none waits on another: every branch
// on the warpgroup is warp-uniform (its index from __shfl_sync) and
// every wait is followed by a wgmma fence, else ptxas serialises the
// products (C7512 / C7520).  The epilogue stages dK or dV as [key][d]
// rows in its warpgroup's tile and stores 16 bytes a thread in the
// (B, Tk, H, D) layout.  A block whose 32 keys are all masked stores
// zeros and exits when its sample has a valid key; query tiles are never
// skipped (no query mask).  At (16, 4, 512, 512) it takes 0.30 ms against
// a bound of 0.07 ms: each tile's loads wait for their one slot, and their
// latency stays on the critical path (NVIDIA H100 80GB HBM3, 700 W).
//
// f32 (parity checks): FMA units, 256 threads, 16 rows by 16 columns of
// S per tile, one entry a thread; each thread then accumulates one row of
// its block over the columns c + 16 j.
//
// Not yet used: K4 on wgmma; in K5 a second Q / dO stage (no room at D
// 512) and a 2-CTA cluster splitting the head dim.  Tried in K5 and
// slower (PERF.md): a TMA multicast of each Q and dO tile to a cluster of
// two key blocks, a 13th warp issuing the loads (ptxas then allows 128
// registers a thread).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using serenade::ld32;
using serenade::ldsm_x4_trans;
using serenade::mma_16816;
using serenade::pack_bf16;

constexpr int MAX_D = 512;
constexpr float NEG_BIG = -1e30f;

struct Heads {
  const void* q;
  long long qsb, qsh, qst;
  const void* k;
  long long ksb, ksh, kst;
  const void* v;
  long long vsb, vsh, vst;
  const float* mask;
  const void* g;  // dO
  long long gsb, gsh, gst;
  const float* lse;   // (B, H, Tq)
  const float* dsum;  // (B, H, Tq)
  int H, Tq, Tk, D;
  float scale;
};

struct Out {
  void* p;
  long long sb, sh, st;
};

__device__ __forceinline__ float key_bias(const float* mb, int t, int Tk) {
  return t < Tk ? (mb ? (1.f - mb[t]) * NEG_BIG : 0.f) : -INFINITY;
}

// ---------------------------------------------------------------------------
// f32: FMA units
// ---------------------------------------------------------------------------

constexpr int F_T = 16;        // rows of a tile
constexpr int F_THREADS = 256;

// rows [t0, t0 + F_T) of a (T, D) f32 matrix into shared memory with row
// stride D + 1 (odd: the 16 rows a warp reads sit in distinct banks)
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         long long st, int t0, int T,
                                         int D) {
  for (int i = threadIdx.x; i < F_T * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    const int t = t0 + r;
    dst[r * (D + 1) + c] = t < T ? src[t * st + c] : 0.f;
  }
}

__device__ __forceinline__ float dot_f32(const float* a, const float* b,
                                         int D) {
  float s = 0.f;
  for (int c = 0; c < D; ++c) s += a[c] * b[c];
  return s;
}

__global__ void __launch_bounds__(F_THREADS)
dq_f32_kernel(Heads a, Out dq) {
  extern __shared__ float4 smem4[];
  const int D = a.D, ld = D + 1;
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + F_T * ld;
  float* Ks = Gs + F_T * ld;
  float* Vs = Ks + F_T * ld;
  float* Ds = Vs + F_T * ld;  // F_T x (F_T + 1)

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * F_T;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh;
  const float* gb = static_cast<const float*>(a.g) + b * a.gsb + h * a.gsh;
  const float* mb = a.mask ? a.mask + (long long)b * a.Tk : nullptr;
  const long long row = ((long long)b * a.H + h) * a.Tq + q0 + r;
  const bool valid = q0 + r < a.Tq;
  const float L = valid ? a.lse[row] : INFINITY;
  const float Dr = valid ? a.dsum[row] : 0.f;

  load_f32(Qs, qb, a.qst, q0, a.Tq, D);
  load_f32(Gs, gb, a.gst, q0, a.Tq, D);
  float acc[MAX_D / F_T];
#pragma unroll
  for (int j = 0; j < MAX_D / F_T; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < a.Tk; k0 += F_T) {
    __syncthreads();  // Q, dO loaded / previous tile consumed
    load_f32(Ks, kb, a.kst, k0, a.Tk, D);
    load_f32(Vs, vb, a.vst, k0, a.Tk, D);
    __syncthreads();
    const float s = dot_f32(Qs + r * ld, Ks + c * ld, D);
    const float dp = dot_f32(Gs + r * ld, Vs + c * ld, D);
    const float p = expf(s * a.scale + key_bias(mb, k0 + c, a.Tk) - L);
    Ds[r * (F_T + 1) + c] = p * (dp - Dr) * a.scale;
    __syncthreads();
    for (int kk = 0; kk < F_T; ++kk) {
      const float ds = Ds[r * (F_T + 1) + kk];
#pragma unroll
      for (int j = 0; j < MAX_D / F_T; ++j)
        if (j < D / F_T) acc[j] += ds * Ks[kk * ld + c + F_T * j];
    }
  }
  if (!valid) return;
  float* o = static_cast<float*>(dq.p) + b * dq.sb + h * dq.sh +
             (q0 + r) * dq.st;
#pragma unroll
  for (int j = 0; j < MAX_D / F_T; ++j)
    if (j < D / F_T) o[c + F_T * j] = acc[j];
}

__global__ void __launch_bounds__(F_THREADS)
dkv_f32_kernel(Heads a, Out dk, Out dv) {
  extern __shared__ float4 smem4[];
  const int D = a.D, ld = D + 1;
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + F_T * ld;
  float* Qs = Vs + F_T * ld;
  float* Gs = Qs + F_T * ld;
  float* Ps = Gs + F_T * ld;      // F_T x (F_T + 1), [key][query]
  float* Ds = Ps + F_T * (F_T + 1);
  float* Ls = Ds + F_T * (F_T + 1);
  float* Dsum = Ls + F_T;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * F_T;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;  // key r, query c
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh;
  const float* gb = static_cast<const float*>(a.g) + b * a.gsb + h * a.gsh;
  const float* mb = a.mask ? a.mask + (long long)b * a.Tk : nullptr;
  const float bias = key_bias(mb, k0 + r, a.Tk);
  const long long row0 = ((long long)b * a.H + h) * a.Tq;

  load_f32(Ks, kb, a.kst, k0, a.Tk, D);
  load_f32(Vs, vb, a.vst, k0, a.Tk, D);
  float dka[MAX_D / F_T], dva[MAX_D / F_T];
#pragma unroll
  for (int j = 0; j < MAX_D / F_T; ++j) dka[j] = dva[j] = 0.f;

  for (int q0 = 0; q0 < a.Tq; q0 += F_T) {
    __syncthreads();
    load_f32(Qs, qb, a.qst, q0, a.Tq, D);
    load_f32(Gs, gb, a.gst, q0, a.Tq, D);
    if (threadIdx.x < F_T) {
      const int t = q0 + threadIdx.x;
      Ls[threadIdx.x] = t < a.Tq ? a.lse[row0 + t] : INFINITY;
      Dsum[threadIdx.x] = t < a.Tq ? a.dsum[row0 + t] : 0.f;
    }
    __syncthreads();
    const float s = dot_f32(Qs + c * ld, Ks + r * ld, D);
    const float dp = dot_f32(Gs + c * ld, Vs + r * ld, D);
    const float p = expf(s * a.scale + bias - Ls[c]);
    Ps[r * (F_T + 1) + c] = p;
    Ds[r * (F_T + 1) + c] = p * (dp - Dsum[c]) * a.scale;
    __syncthreads();
    for (int qq = 0; qq < F_T; ++qq) {
      const float p_ = Ps[r * (F_T + 1) + qq];
      const float ds = Ds[r * (F_T + 1) + qq];
#pragma unroll
      for (int j = 0; j < MAX_D / F_T; ++j) {
        if (j < D / F_T) {
          dva[j] += p_ * Gs[qq * ld + c + F_T * j];
          dka[j] += ds * Qs[qq * ld + c + F_T * j];
        }
      }
    }
  }
  if (k0 + r >= a.Tk) return;
  float* ok = static_cast<float*>(dk.p) + b * dk.sb + h * dk.sh +
              (k0 + r) * dk.st;
  float* ov = static_cast<float*>(dv.p) + b * dv.sb + h * dv.sh +
              (k0 + r) * dv.st;
#pragma unroll
  for (int j = 0; j < MAX_D / F_T; ++j) {
    if (j < D / F_T) {
      ok[c + F_T * j] = dka[j];
      ov[c + F_T * j] = dva[j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulation)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_THREADS = 512;  // 16 warps
constexpr int PAD = 8;           // bf16 row padding: fragment loads avoid
                                 // bank conflicts, rows stay 16-byte aligned
constexpr int DQ_BQ = 64, DQ_BK = 32;    // K4: queries a block, keys a tile

// rows [t0, t0 + rows) of a (T, D) bf16 matrix with row stride st into
// shared memory with row stride D + PAD, 16 bytes a thread; zeros past T
__device__ __forceinline__ void load_bf16(bf16* dst, const bf16* src,
                                          long long st, int t0, int rows,
                                          int T, int D) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    const int t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) val = *reinterpret_cast<const uint4*>(src + t * st + c);
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + c) = val;
  }
}

// acc += A B^T for one 16 x 8 patch over the whole head dim: A rows
// a_row, a_row + 8 and B row b_row of two (rows, D) tiles in shared memory
__device__ __forceinline__ void patch_dot(float (&acc)[4], const bf16* A,
                                          int a_row, const bf16* B, int b_row,
                                          int ld, int D, int t4) {
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* ap = A + a_row * ld + 16 * kk + 2 * t4;
    const uint32_t af[4] = {ld32(ap), ld32(ap + 8 * ld), ld32(ap + 8),
                            ld32(ap + 8 * ld + 8)};
    const bf16* bp = B + b_row * ld + 16 * kk + 2 * t4;
    mma_16816(acc, af, ld32(bp), ld32(bp + 8));
  }
}

// the A fragment of rows r0 + g (+8), columns 16 ks + 2 t4 (+8) of a
// row-major bf16 tile with row stride ld
__device__ __forceinline__ void a_frag(uint32_t (&af)[4], const bf16* base,
                                       int r0, int ks, int ld, int g,
                                       int t4) {
  const bf16* p = base + (r0 + g) * ld + 16 * ks + 2 * t4;
  af[0] = ld32(p);
  af[1] = ld32(p + 8 * ld);
  af[2] = ld32(p + 8);
  af[3] = ld32(p + 8 * ld + 8);
}

__global__ void __launch_bounds__(TC_THREADS, 1)
dq_bf16_kernel(Heads a, Out dq) {
  extern __shared__ float4 smem4[];
  const int D = a.D, ld = D + PAD;
  constexpr int LDS = DQ_BK + PAD;
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Gs = Qs + DQ_BQ * ld;
  bf16* Ks = Gs + DQ_BQ * ld;
  bf16* Vs = Ks + DQ_BK * ld;
  bf16* dSs = Vs + DQ_BK * ld;                                  // 64 x LDS
  float* Ls = reinterpret_cast<float*>(dSs + DQ_BQ * LDS);      // 64
  float* Dsum = Ls + DQ_BQ;                                     // 64
  float* bias_s = Dsum + DQ_BQ;                                 // 32

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * DQ_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = 16 * (warp >> 2);       // this warp's 16 query rows
  const int kt = 8 * (warp & 3);         // phase 1: its 8 keys of a tile
  const int dbase = (warp & 3) * (D / 4);  // phase 2: its quarter of D
  const int nt = D / 32;                 // n8 tiles in a quarter

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ksb + h * a.ksh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vsb + h * a.vsh;
  const bf16* gb = static_cast<const bf16*>(a.g) + b * a.gsb + h * a.gsh;
  const float* mb = a.mask ? a.mask + (long long)b * a.Tk : nullptr;
  const long long row0 = ((long long)b * a.H + h) * a.Tq;

  load_bf16(Qs, qb, a.qst, q0, DQ_BQ, a.Tq, D);
  load_bf16(Gs, gb, a.gst, q0, DQ_BQ, a.Tq, D);
  if (threadIdx.x < DQ_BQ) {
    const int t = q0 + threadIdx.x;
    Ls[threadIdx.x] = t < a.Tq ? a.lse[row0 + t] : INFINITY;
    Dsum[threadIdx.x] = t < a.Tq ? a.dsum[row0 + t] : 0.f;
  }

  float o[MAX_D / 32][4];
#pragma unroll
  for (int n = 0; n < MAX_D / 32; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int k0 = 0; k0 < a.Tk; k0 += DQ_BK) {
    __syncthreads();  // Q, dO loaded / previous tile consumed
    load_bf16(Ks, kb, a.kst, k0, DQ_BK, a.Tk, D);
    load_bf16(Vs, vb, a.vst, k0, DQ_BK, a.Tk, D);
    if (threadIdx.x < DQ_BK)
      bias_s[threadIdx.x] = key_bias(mb, k0 + threadIdx.x, a.Tk);
    __syncthreads();

    // phase 1: S and dP for query rows rg + g (+8), keys kt + 2 t4 (+1)
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    patch_dot(s, Qs, rg + g, Ks, kt + g, ld, D, t4);
    patch_dot(dp, Gs, rg + g, Vs, kt + g, ld, D, t4);
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int r = rg + g + 4 * e;  // e = 0: row g, e = 2: row g + 8
      const int key = kt + 2 * t4;
      const float p0 = expf(s[e] * a.scale + bias_s[key] - Ls[r]);
      const float p1 = expf(s[e + 1] * a.scale + bias_s[key + 1] - Ls[r]);
      *reinterpret_cast<uint32_t*>(dSs + r * LDS + key) =
          pack_bf16(p0 * (dp[e] - Dsum[r]) * a.scale,
                    p1 * (dp[e + 1] - Dsum[r]) * a.scale);
    }
    __syncthreads();

    // phase 2: dQ += dS K over this warp's quarter of the head dim
#pragma unroll
    for (int ks = 0; ks < DQ_BK / 16; ++ks) {
      uint32_t af[4];
      a_frag(af, dSs, rg, ks, LDS, g, t4);
      const bf16* krow = Ks + (16 * ks + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                  ld + dbase + 8 * (lane >> 4);
#pragma unroll
      for (int n = 0; n < MAX_D / 32; n += 2) {
        if (n < nt) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, krow + 8 * n);
          mma_16816(o[n], af, bv[0], bv[1]);
          mma_16816(o[n + 1], af, bv[2], bv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = q0 + rg + g + 8 * half;
    if (t >= a.Tq) continue;
    bf16* orow = static_cast<bf16*>(dq.p) + b * dq.sb + h * dq.sh + t * dq.st +
                 dbase;
#pragma unroll
    for (int n = 0; n < MAX_D / 32; ++n)
      if (n < nt)
        *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t4) =
            pack_bf16(o[n][2 * half], o[n][2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// K5 bf16 on Hopper: wgmma, TMA, warp specialisation
// ---------------------------------------------------------------------------

namespace k5 {

constexpr int HD = 512;               // the head dim this design takes
constexpr int BKEY = 32;              // keys a CTA
constexpr int BQ = 64;                // queries a tile
constexpr int THREADS = 384;
constexpr int QBOX = BQ * 128;        // 64 rows x 64 d, bytes
constexpr int KBOX = BKEY * 128;      // 32 rows x 64 d
constexpr int TILE = 8 * QBOX;        // a Q or dO tile, 64 KB
constexpr int KV = 8 * KBOX;          // K or V, 32 KB
constexpr int PT = BKEY * 128;        // a [key][query] bf16 tile, 4 KB
constexpr int OFF_Q = 0, OFF_G = TILE, OFF_K = 2 * TILE, OFF_V = OFF_K + KV;
constexpr int OFF_PHI = OFF_V + KV, OFF_PLO = OFF_PHI + PT;
constexpr int OFF_DS = OFF_PLO + PT;
constexpr int SMEM = OFF_DS + PT + 1024;   // + alignment
// the epilogue stages dK (in the Q tile) and dV (in the dO tile) as
// [key][d] rows, padded by 16 bytes so neighbouring keys change bank
constexpr int OUT_LD = HD * 2 + 16;
static_assert(BKEY * OUT_LD <= TILE, "a staged gradient fits in its tile");

// the row of key `t` of head h of sample b in dK or dV
__device__ __forceinline__ bf16* out_row(const Out& o, int b, int h, int t) {
  return static_cast<bf16*>(o.p) + b * o.sb + h * o.sh + (long long)t * o.st;
}

// the tile of Q or dO at queries q0.. into `dst`, each half (four
// 64-column blocks, one TMA instruction) once its slot is free; called by
// one thread
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t (&full)[2],
                                          uint64_t (&empty)[2], int parity,
                                          int q0, int h, int b) {
  for (int half = 0; half < 2; ++half) {
    hopper::mbar_wait(&empty[half], parity);
    hopper::mbar_expect_tx(&full[half], TILE / 2);
    hopper::tma_load_blocks(dst + 4 * half * QBOX, map, &full[half], q0,
                            4 * half, h, b);
  }
}

// S (or dP) = the tile's 64 queries x 32 keys of K (or V) over the head
// dim, each half of the tile as it lands.  After each wait the products
// are fenced anew: the wait is a loop, and without the fence ptxas puts
// its own on the loop's path and serialises every product.
__device__ __forceinline__ void scores(float (&d)[16], uint32_t tile,
                                       uint32_t keys, uint64_t (&full)[2],
                                       int ph) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    hopper::mbar_wait(&full[half], ph);
    hopper::wgmma_fence();
    hopper::fence_regs(d);
#pragma unroll
    for (int db = 4 * half; db < 4 * half + 4; ++db)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n32k16_ss<0, 0>(
            d, hopper::desc_sw128(tile + db * QBOX + 32 * kk, 16, 1024),
            hopper::desc_sw128(keys + db * KBOX + 32 * kk, 16, 1024),
            (db | kk) != 0);
    hopper::wgmma_commit();
    hopper::fence_regs(d);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
}

// acc (eight m64 tiles of the gradient^T: d 64 i + row, 32 keys) +=
// tile^T B over the tile's 64 queries, for each B in `bs`; the tile is
// read MN-major (the descriptors' transpose bit), B [key][query] K-major.
// Each half of the tile (four m64 tiles) is freed once its products are
// done (every thread arrives: no branch while a product is in flight),
// so that the next tile's half loads while the other is still read.
template <int NB>
__device__ __forceinline__ void grad_products(float (&acc)[8][16],
                                              uint32_t tile,
                                              const uint32_t (&bs)[NB],
                                              uint64_t (&full)[2],
                                              uint64_t (&empty)[2], int ph) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    hopper::mbar_wait(&full[half], ph);   // landed: warpgroup 0 saw it
    hopper::wgmma_fence();
#pragma unroll
    for (int i = 0; i < 8; ++i) hopper::fence_regs(acc[i]);
#pragma unroll
    for (int i = 4 * half; i < 4 * half + 4; ++i)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int j = 0; j < NB; ++j)
          hopper::wgmma_m64n32k16_ss<1, 0>(
              acc[i],
              hopper::desc_sw128(tile + i * QBOX + ks * 2048, QBOX, 1024),
              hopper::desc_sw128(bs[j] + 32 * ks, 16, 1024), 1);
    hopper::wgmma_commit();
#pragma unroll
    for (int i = 0; i < 8; ++i) hopper::fence_regs(acc[i]);
  }
  hopper::wgmma_wait<1>();
#pragma unroll
  for (int i = 0; i < 4; ++i) hopper::fence_regs(acc[i]);
  hopper::mbar_arrive(&empty[0]);
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int i = 4; i < 8; ++i) hopper::fence_regs(acc[i]);
  hopper::mbar_arrive(&empty[1]);
}

__global__ void __launch_bounds__(THREADS, 1)
dkv_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap g_map,
                const float* __restrict__ mask,
                const float* __restrict__ lse,
                const float* __restrict__ dsum, Out dk, Out dv, int H,
                int Tq, int Tk, float scale) {
  extern __shared__ uint8_t smem_raw[];
  // full / empty [0]: the Q tile, [1]: the dO tile, by halves of four
  // boxes; ready: a tile's P and dS are in shared memory
  __shared__ __align__(8) uint64_t kvfull, full[2][2], empty[2][2], ready;
  __shared__ float kbias[BKEY];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BKEY;
  // the warpgroup, from lane 0: a value ptxas knows is the same in every
  // thread of a warp, so that a branch on it is not divergent (a wgmma
  // on a divergent path is serialised)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int nq = (Tq + BQ - 1) / BQ;
  const float* mb = mask ? mask + (long long)b * Tk : nullptr;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&kvfull, 1);
    hopper::mbar_init(&ready, 1);
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) {
        hopper::mbar_init(&full[i][j], 1);
        hopper::mbar_init(&empty[i][j], 128);   // a warpgroup's threads
      }
    hopper::mbar_fence_init();
  }
  if (threadIdx.x < BKEY) kbias[threadIdx.x] = key_bias(mb, k0 + threadIdx.x,
                                                        Tk);
  // A block whose keys are all masked (mask 0) gets exactly zero dK and
  // dV when its sample has a valid key (mask 1): every P of it is then
  // exp(s - 1e30 - L) = 0 with L finite.  It stores zeros and skips the
  // loads and products.  (With no valid key L is about -1e30 as well and
  // P is not 0, so then no block skips.)
  int any = 0, mine = 0;
  if (mb) {
    for (int t = threadIdx.x; t < Tk; t += THREADS) {
      const float m = mb[t];
      any |= m == 1.f;
      mine |= t >= k0 && t < k0 + BKEY && m != 0.f;
    }
  }
  // the barriers also publish the mbarrier inits and the key bias
  const int sample_valid = __syncthreads_or(any);
  const int block_valid = __syncthreads_or(mine);
  if (mb && sample_valid && !block_valid) {
    for (int c = threadIdx.x; c < 2 * BKEY * 64; c += THREADS) {
      const int key = (c / 64) % BKEY, ch = c % 64;
      if (k0 + key < Tk)
        *reinterpret_cast<uint4*>(
            out_row(c < BKEY * 64 ? dk : dv, b, h, k0 + key) + 8 * ch) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const uint32_t base = hopper::smem_addr(sm);
  if (wg == 0) {
    // ---- warpgroup 0: S = Q K^T and dP = dO V^T (wgmma m64n32k16 over the
    // head dim; element e is query 16 w + g8 + 8 ((e >> 1) & 1), key
    // 8 (e >> 2) + 2 t4 + (e & 1)), P and dS.  Its thread 0 issues every
    // TMA load: K and V once, and a tile's Q (dO) once warpgroup 1 (2) has
    // freed the slot, each at a point where no product is in flight (a
    // thread-divergent branch beside one would serialise them).
    const int w = tid / 32, g8 = (tid % 32) / 4, t4 = tid % 4;
    const long long row0 = ((long long)b * H + h) * Tq;
    if (tid == 0) {
      hopper::mbar_expect_tx(&kvfull, 2 * KV);
      hopper::prefetch_map(&q_map);
      hopper::prefetch_map(&k_map);
      hopper::prefetch_map(&v_map);
      hopper::prefetch_map(&g_map);
      hopper::tma_load_blocks(sm + OFF_K, &k_map, &kvfull, k0, 0, h, b);
      hopper::tma_load_blocks(sm + OFF_V, &v_map, &kvfull, k0, 0, h, b);
      load_tile(sm + OFF_Q, &q_map, full[0], empty[0], 1, 0, h, b);
      load_tile(sm + OFF_G, &g_map, full[1], empty[1], 1, 0, h, b);
    }
    hopper::mbar_wait(&kvfull, 0);
    for (int qt = 0; qt < nq; ++qt) {
      const int ph = qt & 1;
      float L[2], D[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = qt * BQ + 16 * w + g8 + 8 * r;
        L[r] = q < Tq ? lse[row0 + q] : INFINITY;   // P = 0 past Tq
        D[r] = q < Tq ? dsum[row0 + q] : 0.f;
      }
      float s[16], dp[16];
      if (qt > 0 && tid == 0) {
        // each half as the last tile's dK (Q) and dV (dO) free them, in
        // that order: the dO load then overlaps Q's and S
        load_tile(sm + OFF_Q, &q_map, full[0], empty[0], ph ^ 1, qt * BQ, h,
                  b);
        load_tile(sm + OFF_G, &g_map, full[1], empty[1], ph ^ 1, qt * BQ, h,
                  b);
      }
      scores(s, base + OFF_Q, base + OFF_K, full[0], ph);
      // P = exp(S scale + key bias - L)
#pragma unroll
      for (int e = 0; e < 16; ++e)
        s[e] = expf(s[e] * scale + kbias[8 * (e >> 2) + 2 * t4 + (e & 1)] -
                    L[(e >> 1) & 1]);
      scores(dp, base + OFF_G, base + OFF_V, full[1], ph);
      // dS = P (dP - D) scale, cast to bf16 for dK as JAX casts it; P as
      // bf16 hi + lo (16 bits of mantissa) for dV, where JAX keeps P f32.
      // All three as [key][query] rows, 128-byte swizzled: K-major B
      // operands.  The slots are free: warpgroups 1 and 2 were done with
      // the last tile's before its Q and dO were loaded.
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int q = 16 * w + g8 + 8 * ((e >> 1) & 1);
        const int key = 8 * (e >> 2) + 2 * t4 + (e & 1);
        const uint32_t off = hopper::sw128(key, 2 * q);
        const bf16 hi = __float2bfloat16(s[e]);
        *reinterpret_cast<bf16*>(sm + OFF_PHI + off) = hi;
        *reinterpret_cast<bf16*>(sm + OFF_PLO + off) =
            __float2bfloat16(s[e] - __bfloat162float(hi));
        *reinterpret_cast<bf16*>(sm + OFF_DS + off) =
            __float2bfloat16(s[e] * (dp[e] - D[(e >> 1) & 1]) * scale);
      }
      hopper::fence_async_shared();
      hopper::named_barrier(1, 128);
      if (tid == 0) hopper::mbar_arrive(&ready);
    }
    return;
  }

  // ---- warpgroup 1: dK^T += Q^T dS; warpgroup 2: dV^T += dO^T P, P as
  // hi then lo.  M = head dim (eight m64 tiles), N = 32 keys, K = 64
  // queries; each holds its gradient's 512 x 32 in 128 registers a
  // thread, and frees its tile after its products.
  const int cw = wg - 1;
  uint8_t* own = sm + (cw ? OFF_G : OFF_Q);
  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[i][e] = 0.f;
  for (int qt = 0; qt < nq; ++qt) {
    hopper::mbar_wait(&ready, qt & 1);
    if (cw == 0) {
      const uint32_t bs[1] = {base + OFF_DS};
      grad_products(acc, base + OFF_Q, bs, full[0], empty[0], qt & 1);
    } else {
      const uint32_t bs[2] = {base + OFF_PHI, base + OFF_PLO};
      grad_products(acc, base + OFF_G, bs, full[1], empty[1], qt & 1);
    }
  }

  // epilogue: the gradient^T through shared memory (its own tile: nothing
  // reads it any more) to (key, d) rows of dK or dV, 16 bytes a store.
  // Element e of acc[i] is d 64 i + 16 w + g8 + 8 ((e >> 1) & 1), key
  // 8 (e >> 2) + 2 t4 + (e & 1).
  const int w = tid / 32, g8 = (tid % 32) / 4, t4 = tid % 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int d = 64 * i + 16 * w + g8 + 8 * ((e >> 1) & 1);
      const int key = 8 * (e >> 2) + 2 * t4 + (e & 1);
      *reinterpret_cast<bf16*>(own + key * OUT_LD + 2 * d) =
          __float2bfloat16(acc[i][e]);
    }
  hopper::named_barrier(2 + cw, 128);
  const Out& o = cw ? dv : dk;
  for (int c = tid; c < BKEY * 64; c += 128) {
    const int key = c / 64, ch = c % 64;
    if (k0 + key < Tk)
      *reinterpret_cast<uint4*>(out_row(o, b, h, k0 + key) + 8 * ch) =
          *reinterpret_cast<const uint4*>(own + key * OUT_LD + 16 * ch);
  }
}

}  // namespace k5

Heads make_heads(const void* q, long long qsb, long long qsh, long long qst,
                 const void* k, long long ksb, long long ksh, long long kst,
                 const void* v, long long vsb, long long vsh, long long vst,
                 const float* mask, const void* g, long long gsb,
                 long long gsh, long long gst, const float* lse,
                 const float* dsum, int H, int Tq, int Tk, int D,
                 float scale) {
  return Heads{q,  qsb, qsh, qst, k,   ksb,  ksh, kst, v,  vsb, vsh, vst,
               mask, g, gsb, gsh, gst, lse, dsum, H,  Tq, Tk, D,   scale};
}

// 0 if the shapes and layouts suit the kernels of this dtype
int check_args(const Heads& a, int B, int dtype) {
  if (a.D % 32 != 0 || a.D > MAX_D || B <= 0 || a.H <= 0 || a.Tq <= 0 ||
      a.Tk <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    // 16-byte row loads need 8-element-aligned rows; phase 2 splits the
    // head dim in eighths of pairs of n8 tiles
    const long long st[] = {a.qsb, a.qsh, a.qst, a.ksb, a.ksh, a.kst,
                            a.vsb, a.vsh, a.vst, a.gsb, a.gsh, a.gst};
    for (long long s : st)
      if (s % 8) return (int)cudaErrorInvalidValue;
    if (a.D % 128 ||
        (reinterpret_cast<size_t>(a.q) | reinterpret_cast<size_t>(a.k) |
         reinterpret_cast<size_t>(a.v) | reinterpret_cast<size_t>(a.g)) % 16)
      return (int)cudaErrorInvalidValue;
  } else if (dtype != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename K, typename... Args>
int launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

#define SERENADE_HEAD_ARGS                                                    \
  const void *q, long long qsb, long long qsh, long long qst, const void *k,  \
      long long ksb, long long ksh, long long kst, const void *v,             \
      long long vsb, long long vsh, long long vst, const float *mask,         \
      const void *g, long long gsb, long long gsh, long long gst,             \
      const float *lse, const float *dsum

extern "C" int serenade_flash_bwd_dq(SERENADE_HEAD_ARGS, void* dq,
                                     long long dsb, long long dsh,
                                     long long dst, int B, int H, int Tq,
                                     int Tk, int D, float scale, int dtype,
                                     cudaStream_t stream) {
  const Heads a = make_heads(q, qsb, qsh, qst, k, ksb, ksh, kst, v, vsb, vsh,
                             vst, mask, g, gsb, gsh, gst, lse, dsum, H, Tq,
                             Tk, D, scale);
  const int bad = check_args(a, B, dtype);
  if (bad) return bad;
  const Out o{dq, dsb, dsh, dst};
  if (dtype == 1) {
    if (dst % 2) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(bf16) * ((size_t)(2 * DQ_BQ + 2 * DQ_BK) *
                                            (D + PAD) +
                                        (size_t)DQ_BQ * (DQ_BK + PAD)) +
                        sizeof(float) * (2 * DQ_BQ + DQ_BK);
    return launch(dq_bf16_kernel, dim3((Tq + DQ_BQ - 1) / DQ_BQ, H, B),
                  TC_THREADS, smem, stream, a, o);
  }
  const size_t smem =
      sizeof(float) * ((size_t)4 * F_T * (D + 1) + F_T * (F_T + 1));
  return launch(dq_f32_kernel, dim3((Tq + F_T - 1) / F_T, H, B), F_THREADS,
                smem, stream, a, o);
}

// The caller plans the launch (ops/flash_cuda.py k5_plan): grid
// (grid_x, H, B), `threads` a CTA and `smem` bytes of dynamic shared
// memory.  bf16 takes head_dim 512 only, on the Hopper kernel; a plan that
// does not match either kernel's own keys a CTA, threads and shared
// memory returns cudaErrorInvalidValue.
extern "C" int serenade_flash_bwd_dkv(SERENADE_HEAD_ARGS, void* dk,
                                      long long dksb, long long dksh,
                                      long long dkst, void* dv,
                                      long long dvsb, long long dvsh,
                                      long long dvst, int B, int H, int Tq,
                                      int Tk, int D, float scale, int dtype,
                                      int grid_x, int threads, int smem,
                                      cudaStream_t stream) {
  const Heads a = make_heads(q, qsb, qsh, qst, k, ksb, ksh, kst, v, vsb, vsh,
                             vst, mask, g, gsb, gsh, gst, lse, dsum, H, Tq,
                             Tk, D, scale);
  const int bad = check_args(a, B, dtype);
  if (bad) return bad;
  const Out ok{dk, dksb, dksh, dkst}, ov{dv, dvsb, dvsh, dvst};
  if (dtype == 1) {
    // 16-byte stores of dK and dV rows
    const long long st[] = {dksb, dksh, dkst, dvsb, dvsh, dvst};
    for (long long x : st)
      if (x % 8) return (int)cudaErrorInvalidValue;
    if (D != k5::HD || grid_x != (Tk + k5::BKEY - 1) / k5::BKEY ||
        threads != k5::THREADS || smem != k5::SMEM ||
        (reinterpret_cast<size_t>(dk) | reinterpret_cast<size_t>(dv)) % 16)
      return (int)cudaErrorInvalidValue;
    // 5-D maps over the strided (B, H, T, D) views: boxes of 64 columns x
    // 64 rows x 4 column blocks (half a Q or dO tile) or x 32 rows x 8
    // blocks (all of K or V)
    CUtensorMap maps[4];
    const void* ptrs[4] = {q, k, v, g};
    const long long sb[4] = {qsb, ksb, vsb, gsb}, sh[4] = {qsh, ksh, vsh, gsh},
                    stt[4] = {qst, kst, vst, gst};
    const int rows[4] = {k5::BQ, k5::BKEY, k5::BKEY, k5::BQ};
    const int blocks[4] = {4, 8, 8, 4};
    const int lens[4] = {Tq, Tk, Tk, Tq};
    for (int i = 0; i < 4; ++i) {
      const int e = hopper::encode_heads_blocks(&maps[i], ptrs[i], sb[i],
                                                sh[i], stt[i], B, H, lens[i],
                                                D, rows[i], blocks[i]);
      if (e) return e;
    }
    return launch(k5::dkv_bf16_kernel, dim3(grid_x, H, B), threads, smem,
                  stream, maps[0], maps[1], maps[2], maps[3], mask, lse, dsum,
                  ok, ov, H, Tq, Tk, scale);
  }
  if (grid_x != (Tk + F_T - 1) / F_T || threads != F_THREADS ||
      (size_t)smem != sizeof(float) * ((size_t)4 * F_T * (D + 1) +
                                       2 * F_T * (F_T + 1) + 2 * F_T))
    return (int)cudaErrorInvalidValue;
  return launch(dkv_f32_kernel, dim3(grid_x, H, B), threads, smem, stream, a,
                ok, ov);
}
