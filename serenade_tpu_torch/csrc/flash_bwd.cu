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
// bf16 (the training path), tensor cores through mma.sync m16n8k16 with
// f32 accumulation, one block of 16 warps (512 threads, one block an SM):
//
// K4: a block owns 64 query rows of one (b, h) and keeps Q and dO for
// them in shared memory (133 KB at D 512); it loops over 32-key tiles of
// K and V (67 KB).  Phase 1: warp w computes the 16 x 8 patch (query rows
// 16 (w / 4), keys 8 (w % 4)) of both S and dP over the whole head dim,
// forms dS in registers and stores it as bf16 (JAX casts dS to K's type).
// Phase 2: warp w adds dS K for query rows 16 (w / 4) and a quarter of
// the head dim (D / 4 columns, 64 f32 accumulators a thread), reading K
// with ldmatrix.trans.  No product is computed twice.
//
// K5: a block owns 32 keys of one (b, h) and all D columns of their dK and
// dV, so the accumulators (2 x 32 x 512 f32) are spread over 512 threads,
// 64 registers each: the choice of fewer keys per block over splitting
// the head dim across blocks, which would recompute S and dP once per
// split.  It loops over 64-query tiles of Q and dO.  Phase 1: warp w
// computes the 16 x 8 patch (keys 16 (w / 8), queries 8 (w % 8)) of S^T
// and dP^T, and stores P^T and dS^T.  P stays f32 in JAX's dV product, so
// it is stored as two bf16 terms (hi + lo, 16 bits of mantissa) and dV
// takes two products, one more product per tile (5 instead of 4).
// Phase 2: warp w adds P^T dO and dS^T Q for keys 16 (w / 8) and an eighth
// of the head dim.
//
// f32 (parity checks): FMA units, 256 threads, 16 rows by 16 columns of
// S per tile, one entry a thread; each thread then accumulates one row of
// its block over the columns c + 16 j.
//
// Not yet used: wgmma, TMA, and a pipeline overlapping loads with math.
#include "common.cuh"

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
constexpr int KV_BK = 32, KV_BQ = 64;    // K5: keys a block, queries a tile

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

__global__ void __launch_bounds__(TC_THREADS, 1)
dkv_bf16_kernel(Heads a, Out dk, Out dv) {
  extern __shared__ float4 smem4[];
  const int D = a.D, ld = D + PAD;
  constexpr int LDP = KV_BQ + PAD;
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + KV_BK * ld;
  bf16* Qs = Vs + KV_BK * ld;
  bf16* Gs = Qs + KV_BQ * ld;
  bf16* Phi = Gs + KV_BQ * ld;       // P^T [key][query], high bf16 term
  bf16* Plo = Phi + KV_BK * LDP;     // P^T, the rest of f32 P
  bf16* dSt = Plo + KV_BK * LDP;     // dS^T
  float* Ls = reinterpret_cast<float*>(dSt + KV_BK * LDP);  // KV_BQ
  float* Dsum = Ls + KV_BQ;                                 // KV_BQ
  float* bias_s = Dsum + KV_BQ;                             // KV_BK

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * KV_BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kg = 16 * (warp >> 3);        // this warp's 16 keys
  const int qt = 8 * (warp & 7);          // phase 1: its 8 queries of a tile
  const int dbase = (warp & 7) * (D / 8);  // phase 2: its eighth of D
  const int nt = D / 64;                  // n8 tiles in an eighth

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ksb + h * a.ksh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vsb + h * a.vsh;
  const bf16* gb = static_cast<const bf16*>(a.g) + b * a.gsb + h * a.gsh;
  const float* mb = a.mask ? a.mask + (long long)b * a.Tk : nullptr;
  const long long row0 = ((long long)b * a.H + h) * a.Tq;

  load_bf16(Ks, kb, a.kst, k0, KV_BK, a.Tk, D);
  load_bf16(Vs, vb, a.vst, k0, KV_BK, a.Tk, D);
  if (threadIdx.x < KV_BK)
    bias_s[threadIdx.x] = key_bias(mb, k0 + threadIdx.x, a.Tk);

  float dka[MAX_D / 64][4], dva[MAX_D / 64][4];
#pragma unroll
  for (int n = 0; n < MAX_D / 64; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int q0 = 0; q0 < a.Tq; q0 += KV_BQ) {
    __syncthreads();  // K, V loaded / previous tile consumed
    load_bf16(Qs, qb, a.qst, q0, KV_BQ, a.Tq, D);
    load_bf16(Gs, gb, a.gst, q0, KV_BQ, a.Tq, D);
    if (threadIdx.x < KV_BQ) {
      const int t = q0 + threadIdx.x;
      Ls[threadIdx.x] = t < a.Tq ? a.lse[row0 + t] : INFINITY;
      Dsum[threadIdx.x] = t < a.Tq ? a.dsum[row0 + t] : 0.f;
    }
    __syncthreads();

    // phase 1: S^T and dP^T for keys kg + g (+8), queries qt + 2 t4 (+1)
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    patch_dot(s, Ks, kg + g, Qs, qt + g, ld, D, t4);
    patch_dot(dp, Vs, kg + g, Gs, qt + g, ld, D, t4);
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int key = kg + g + 4 * e;
      const int qc = qt + 2 * t4;
      float p[2], ds[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        p[u] = expf(s[e + u] * a.scale + bias_s[key] - Ls[qc + u]);
        ds[u] = p[u] * (dp[e + u] - Dsum[qc + u]) * a.scale;
      }
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p[0], p[1]);
      const float2 hf = __bfloat1622float2(hi);
      *reinterpret_cast<__nv_bfloat162*>(Phi + key * LDP + qc) = hi;
      *reinterpret_cast<uint32_t*>(Plo + key * LDP + qc) =
          pack_bf16(p[0] - hf.x, p[1] - hf.y);
      *reinterpret_cast<uint32_t*>(dSt + key * LDP + qc) =
          pack_bf16(ds[0], ds[1]);
    }
    __syncthreads();

    // phase 2: dV += P^T dO and dK += dS^T Q over this warp's eighth of D
#pragma unroll
    for (int ks = 0; ks < KV_BQ / 16; ++ks) {
      uint32_t ahi[4], alo[4], ads[4];
      a_frag(ahi, Phi, kg, ks, LDP, g, t4);
      a_frag(alo, Plo, kg, ks, LDP, g, t4);
      a_frag(ads, dSt, kg, ks, LDP, g, t4);
      const int off = (16 * ks + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld +
                      dbase + 8 * (lane >> 4);
#pragma unroll
      for (int n = 0; n < MAX_D / 64; n += 2) {
        if (n < nt) {
          uint32_t bg[4], bq[4];
          ldsm_x4_trans(bg, Gs + off + 8 * n);
          ldsm_x4_trans(bq, Qs + off + 8 * n);
          mma_16816(dva[n], ahi, bg[0], bg[1]);
          mma_16816(dva[n], alo, bg[0], bg[1]);
          mma_16816(dva[n + 1], ahi, bg[2], bg[3]);
          mma_16816(dva[n + 1], alo, bg[2], bg[3]);
          mma_16816(dka[n], ads, bq[0], bq[1]);
          mma_16816(dka[n + 1], ads, bq[2], bq[3]);
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = k0 + kg + g + 8 * half;
    if (t >= a.Tk) continue;
    bf16* krow = static_cast<bf16*>(dk.p) + b * dk.sb + h * dk.sh + t * dk.st +
                 dbase;
    bf16* vrow = static_cast<bf16*>(dv.p) + b * dv.sb + h * dv.sh + t * dv.st +
                 dbase;
#pragma unroll
    for (int n = 0; n < MAX_D / 64; ++n) {
      if (n < nt) {
        *reinterpret_cast<uint32_t*>(krow + 8 * n + 2 * t4) =
            pack_bf16(dka[n][2 * half], dka[n][2 * half + 1]);
        *reinterpret_cast<uint32_t*>(vrow + 8 * n + 2 * t4) =
            pack_bf16(dva[n][2 * half], dva[n][2 * half + 1]);
      }
    }
  }
}

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

extern "C" int serenade_flash_bwd_dkv(SERENADE_HEAD_ARGS, void* dk,
                                      long long dksb, long long dksh,
                                      long long dkst, void* dv,
                                      long long dvsb, long long dvsh,
                                      long long dvst, int B, int H, int Tq,
                                      int Tk, int D, float scale, int dtype,
                                      cudaStream_t stream) {
  const Heads a = make_heads(q, qsb, qsh, qst, k, ksb, ksh, kst, v, vsb, vsh,
                             vst, mask, g, gsb, gsh, gst, lse, dsum, H, Tq,
                             Tk, D, scale);
  const int bad = check_args(a, B, dtype);
  if (bad) return bad;
  const Out ok{dk, dksb, dksh, dkst}, ov{dv, dvsb, dvsh, dvst};
  if (dtype == 1) {
    if (dkst % 2 || dvst % 2) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(bf16) * ((size_t)(2 * KV_BK + 2 * KV_BQ) *
                                            (D + PAD) +
                                        (size_t)3 * KV_BK * (KV_BQ + PAD)) +
                        sizeof(float) * (2 * KV_BQ + KV_BK);
    return launch(dkv_bf16_kernel, dim3((Tk + KV_BK - 1) / KV_BK, H, B),
                  TC_THREADS, smem, stream, a, ok, ov);
  }
  const size_t smem = sizeof(float) * ((size_t)4 * F_T * (D + 1) +
                                       2 * F_T * (F_T + 1) + 2 * F_T);
  return launch(dkv_f32_kernel, dim3((Tk + F_T - 1) / F_T, H, B), F_THREADS,
                smem, stream, a, ok, ov);
}
