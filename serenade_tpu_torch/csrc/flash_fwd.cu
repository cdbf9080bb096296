// K1: flash-attention forward for the UNet self-attention.
//
// Replaces serenade_tpu/ops/flash_pallas.py:106 (_flash_forward ->
// _fwd_kernel): O = softmax(Q K^T * scale + key-mask bias) V with an
// online softmax in f32, plus the f32 row logsumexp L (B, H, Tq) that the
// backward kernels of the training slice need.  Padded keys get a -1e30
// bias; keys past Tk (the ragged tail of the last tile) get no weight.
//
// What bounds it on the H100: head_dim is 512.  One 64-row bf16 tile of
// each of Q, K and V is 192 KB of the 227 KB of shared memory, and a
// 64 x 512 f32 accumulator is 128 KB, so the TPU's 256 x 512 blocks do not
// carry over.  At the serving shape (B 1, H 4, T 1536, D 512) the work is
// 19 GFLOP against 12.6 MB of inputs and outputs: operations bound it.
//
// Two kernels, chosen by dtype.
//
// bf16 (the serving path): tensor cores through mma.sync m16n8k16 with
// f32 accumulation, FlashAttention-2 style.  One block of 8 warps per
// (b, h, 64-query tile) loops over 32-key tiles; Q, K and V tiles sit in
// shared memory as bf16 (rows padded by 8 elements, so fragment loads hit
// distinct banks): 130 KB at D = 512.  Warp w owns query rows
// 16 (w % 4) .. +15 and half of the head dim: the two warps of a row group
// both compute the full S = Q K^T tile (so they agree on the row max and
// sum without talking) and each multiplies P by its half of V, keeping
// 16 x 256 f32 accumulators (128 registers a thread) whose rows are known,
// so the online-softmax rescale happens in registers.  P is rounded to
// bf16 for the P V product, as the Pallas kernel casts it to V's dtype.
//
// f32 (parity checks): one block of 256 threads per (b, h, 32-query
// tile) on FMA units.  Q, K and V tiles are held as f32 (197 KB at
// D = 512); thread (r, l) owns query row r = tid / 8, computes keys
// l, l+8, l+16, l+24 of S with float4 dot products, reduces the row's max
// and sum over its 8 threads with shuffles, and accumulates columns
// 4l + 32j of the row's output in registers.
//
// Not yet used: wgmma, TMA, and a pipeline overlapping loads with math.
#include "common.cuh"

namespace {

using serenade::ld32;
using serenade::ldsm_x4_trans;
using serenade::mma_16816;
using serenade::pack_bf16;

constexpr int BQ = 32;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int MAX_D = 512;
constexpr float NEG_BIG = -1e30f;

__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, long long qsb, long long qsh,
                 long long qst, const float* __restrict__ k, long long ksb,
                 long long ksh, long long kst, const float* __restrict__ v,
                 long long vsb, long long vsh, long long vst,
                 const float* __restrict__ mask, float* __restrict__ out,
                 long long osb, long long osh, long long ost,
                 float* __restrict__ lse, int H, int Tq, int Tk, int D,
                 float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = D + 4;
  float* Qs = smem;             // BQ x ld
  float* Ks = Qs + BQ * ld;     // BK x ld
  float* Vs = Ks + BK * ld;     // BK x D
  float* Ps = Vs + BK * D;      // BQ x (BK + 1)

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int l8 = tid & 7;
  const int nj = D / 32;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  const float* mb = mask ? mask + (long long)b * Tk : nullptr;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, dd = i - rr * D;
    const int t = q0 + rr;
    Qs[rr * ld + dd] = t < Tq ? qb[t * qst + dd] : 0.f;
  }

  float acc[MAX_D / 8];
#pragma unroll
  for (int i = 0; i < MAX_D / 8; ++i) acc[i] = 0.f;
  float m = NEG_BIG, lsum = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // Q loaded / previous K, V tile consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int rr = i / D, dd = i - rr * D;
      const int t = k0 + rr;
      float kv = 0.f, vv = 0.f;
      if (t < Tk) {
        kv = kb[t * kst + dd];
        vv = vb[t * vst + dd];
      }
      Ks[rr * ld + dd] = kv;
      Vs[rr * D + dd] = vv;
    }
    __syncthreads();

    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const float4* qrow = reinterpret_cast<const float4*>(Qs + r * ld);
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 qa = qrow[d4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 kk =
            reinterpret_cast<const float4*>(Ks + (l8 + 8 * i) * ld)[d4];
        s[i] += qa.x * kk.x + qa.y * kk.y + qa.z * kk.z + qa.w * kk.w;
      }
    }
    float mcur = NEG_BIG;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = k0 + l8 + 8 * i;
      if (t < Tk) {
        s[i] = s[i] * scale + (mb ? (1.f - mb[t]) * NEG_BIG : 0.f);
        mcur = fmaxf(mcur, s[i]);
      } else {
        s[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, off));
    const float mnew = fmaxf(m, mcur);
    const float corr = expf(m - mnew);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = expf(s[i] - mnew);
      psum += p;
      Ps[r * (BK + 1) + l8 + 8 * i] = p;
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    lsum = lsum * corr + psum;
    m = mnew;
    __syncwarp();  // row r's P is written by the 8 threads of this warp

#pragma unroll
    for (int i = 0; i < MAX_D / 8; ++i) acc[i] *= corr;
    const int kmax = min(BK, Tk - k0);
    for (int c = 0; c < kmax; ++c) {
      const float p = Ps[r * (BK + 1) + c];
      const float4* vrow = reinterpret_cast<const float4*>(Vs + c * D);
#pragma unroll
      for (int j = 0; j < MAX_D / 32; ++j) {
        if (j < nj) {
          const float4 vv = vrow[l8 + 8 * j];
          acc[4 * j + 0] += p * vv.x;
          acc[4 * j + 1] += p * vv.y;
          acc[4 * j + 2] += p * vv.z;
          acc[4 * j + 3] += p * vv.w;
        }
      }
    }
  }

  const int t = q0 + r;
  if (t < Tq) {
    const float denom = fmaxf(lsum, 1e-30f);
    const float inv = 1.f / denom;
    float* orow = out + b * osb + h * osh + t * ost;
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j) {
      if (j < nj) {
        const int c = 4 * l8 + 32 * j;
        orow[c + 0] = acc[4 * j + 0] * inv;
        orow[c + 1] = acc[4 * j + 1] * inv;
        orow[c + 2] = acc[4 * j + 2] * inv;
        orow[c + 3] = acc[4 * j + 3] * inv;
      }
    }
    if (l8 == 0) lse[((long long)b * H + h) * Tq + t] = m + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulation)
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 64;    // query rows per block (4 row groups of 16)
constexpr int TC_BK = 32;    // keys per tile
constexpr int TC_PAD = 8;    // bf16 row padding: fragment loads avoid conflicts
constexpr int TC_MAX_NT = MAX_D / 16;   // n8 tiles in half of the head dim

// Rows [t0, t0 + rows) of a (T, D) bf16 matrix with row stride st into
// shared memory with row stride D + TC_PAD, 16 bytes a thread; zeros past T.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long st, int t0, int rows,
                                          int T, int D) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    const int t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) val = *reinterpret_cast<const uint4*>(src + t * st + c);
    *reinterpret_cast<uint4*>(dst + r * (D + TC_PAD) + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, long long qsb,
                      long long qsh, long long qst,
                      const __nv_bfloat16* __restrict__ k, long long ksb,
                      long long ksh, long long kst,
                      const __nv_bfloat16* __restrict__ v, long long vsb,
                      long long vsh, long long vst,
                      const float* __restrict__ mask,
                      __nv_bfloat16* __restrict__ out, long long osb,
                      long long osh, long long ost, float* __restrict__ lse,
                      int H, int Tq, int Tk, int D, float scale) {
  extern __shared__ float4 smem4[];
  const int ld = D + TC_PAD;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Ks = Qs + TC_BQ * ld;
  __nv_bfloat16* Vs = Ks + TC_BK * ld;
  float* bias_s = reinterpret_cast<float*>(Vs + TC_BK * ld);

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * TC_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * (warp & 3);          // this warp's 16 query rows
  const int dbase = (warp >> 2) * (D / 2);  // and half of the head dim
  const int nt = D / 16;

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;
  const float* mb = mask ? mask + (long long)b * Tk : nullptr;

  load_tile(Qs, qb, qst, q0, TC_BQ, Tq, D);

  float o[TC_MAX_NT][4];
#pragma unroll
  for (int n = 0; n < TC_MAX_NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < Tk; k0 += TC_BK) {
    __syncthreads();  // Q loaded / previous K, V tiles consumed
    load_tile(Ks, kb, kst, k0, TC_BK, Tk, D);
    load_tile(Vs, vb, vst, k0, TC_BK, Tk, D);
    if (threadIdx.x < TC_BK) {
      const int t = k0 + threadIdx.x;
      bias_s[threadIdx.x] =
          t < Tk ? (mb ? (1.f - mb[t]) * NEG_BIG : 0.f) : -INFINITY;
    }
    __syncthreads();

    // S = Q K^T for rows r0 + g, r0 + g + 8 and this tile's 32 keys
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + (r0 + g) * ld + 16 * kk + 2 * t4;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * ld), ld32(qa + 8),
                             ld32(qa + 8 * ld + 8)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* kp = Ks + (8 * j + g) * ld + 16 * kk + 2 * t4;
        mma_16816(s[j], a, ld32(kp), ld32(kp + 8));
      }
    }

    // online softmax; element e of tile j is row g + 8 (e >> 1),
    // key 8 j + 2 t4 + (e & 1); a row's 32 keys live in 4 lanes
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = s[j][e] * scale + bias_s[8 * j + 2 * t4 + (e & 1)];
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mnew = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - mnew);
      m[r] = mnew;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        psum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int n = 0; n < TC_MAX_NT; ++n) {
      if (n < nt) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
    }

    // O += P V over this warp's half of the head dim; the S accumulators
    // of key tiles 2ks, 2ks+1 are exactly the A fragment of P
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * ks][0], s[2 * ks][1]),
          pack_bf16(s[2 * ks][2], s[2 * ks][3]),
          pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
          pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      const __nv_bfloat16* vrow =
          Vs + (16 * ks + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + dbase +
          8 * (lane >> 4);
#pragma unroll
      for (int n = 0; n < TC_MAX_NT; n += 2) {
        if (n < nt) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, vrow + 8 * n);
          mma_16816(o[n], a, bv[0], bv[1]);
          mma_16816(o[n + 1], a, bv[2], bv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= Tq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / denom;
    __nv_bfloat16* orow = out + b * osb + h * osh + row * ost + dbase;
#pragma unroll
    for (int n = 0; n < TC_MAX_NT; ++n) {
      if (n < nt) {
        *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t4) =
            pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      }
    }
    if (dbase == 0 && t4 == 0)
      lse[((long long)b * H + h) * Tq + row] = m[r] + logf(denom);
  }
}

}  // namespace

extern "C" int serenade_flash_fwd(
    const void* q, long long qsb, long long qsh, long long qst, const void* k,
    long long ksb, long long ksh, long long kst, const void* v, long long vsb,
    long long vsh, long long vst, const float* mask, void* out, long long osb,
    long long osh, long long ost, float* lse, int B, int H, int Tq, int Tk,
    int D, float scale, int dtype, cudaStream_t stream) {
  if (D % 32 != 0 || D > MAX_D || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    // 16-byte row loads need 8-element-aligned rows
    if (qst % 8 || kst % 8 || vst % 8 || qsb % 8 || qsh % 8 || ksb % 8 ||
        ksh % 8 || vsb % 8 || vsh % 8 || ost % 2 ||
        (reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(k) |
         reinterpret_cast<size_t>(v)) % 16)
      return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(__nv_bfloat16) * (size_t)(TC_BQ + 2 * TC_BK) *
                            (D + TC_PAD) + sizeof(float) * TC_BK;
    const dim3 grid((Tq + TC_BQ - 1) / TC_BQ, H, B);
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    flash_fwd_bf16_kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), qsb, qsh, qst,
        static_cast<const __nv_bfloat16*>(k), ksb, ksh, kst,
        static_cast<const __nv_bfloat16*>(v), vsb, vsh, vst, mask,
        static_cast<__nv_bfloat16*>(out), osb, osh, ost, lse, H, Tq, Tk, D,
        scale);
  } else if (dtype == 0) {
    const size_t smem =
        sizeof(float) * ((size_t)(BQ + BK) * (D + 4) + (size_t)BK * D +
                         (size_t)BQ * (BK + 1));
    const dim3 grid((Tq + BQ - 1) / BQ, H, B);
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    flash_fwd_f32_kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), qsb, qsh, qst,
        static_cast<const float*>(k), ksb, ksh, kst,
        static_cast<const float*>(v), vsb, vsh, vst, mask,
        static_cast<float*>(out), osb, osh, ost, lse, H, Tq, Tk, D, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
