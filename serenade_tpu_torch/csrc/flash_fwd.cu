// K1: flash-attention forward for the UNet self-attention.
//
// Replaces serenade_tpu/ops/flash_pallas.py:106 (_flash_forward ->
// _fwd_kernel): O = softmax(Q K^T * scale + key-mask bias) V with an
// online softmax in f32, plus the f32 row logsumexp L (B, H, Tq) that the
// backward kernels of the training slice need.  Padded keys get a -1e30
// bias; keys past Tk (the ragged tail of the last tile) get no weight.
//
// What bounds it on the H100: head_dim is 512 (Serenade) or 256 (NUSVC).
// At 512 one 64-row bf16 tile of
// each of Q, K and V is 192 KB of the 227 KB of shared memory, and a
// 64 x 512 f32 accumulator is 128 KB, so the TPU's 256 x 512 blocks do not
// carry over.  At the serving shape (B 1, H 4, T 1536, D 512) the work is
// 19 GFLOP against 12.6 MB of inputs and outputs: operations bound it
// (19.5 us at 989 TFLOP/s); the bf16 kernel takes 124 us there, SDPA
// 199 us (NVIDIA H100 80GB HBM3, 700 W).
//
// Two kernels, chosen by dtype.
//
// bf16 (the serving and training path), designed for Hopper at head_dim
// 512 and templated on it (HD): HD 256 keeps the same layout with every
// tile and accumulator at half the columns (the wrapper raises on another
// head dim).  Described at 512 below.  One CTA of 384 threads per
// (b, h, 64-query tile).  Warpgroup 0 is the producer: one thread loads
// the Q tile once (64 KB) and keeps a ring of two stages of 32 keys of K
// and V (64 KB a stage) in flight with TMA (4-D tensor maps over the
// strided (B, H, T, D) views, 8 boxes of 64 columns a tile, 128-byte
// swizzle, zeros past T), completed through mbarriers.  Warpgroups 1 and
// 2 (setmaxnreg 232) split the head dim: each computes the partial
// S = Q K^T over its 256 columns (wgmma m64n32k16, both operands
// K-major), the two swap partials through 32 KB of shared memory so both
// apply the same row max and sum (S costs its FLOPs once, where an
// mma.sync design with both halves computing all of S costs it twice),
// run the online softmax in f32 in registers and multiply P, rounded to
// bf16 and taken from registers as wgmma's A, by their 256 columns of V
// (m64n256k16, V MN-major): 64 x 256 f32 of O in 128 registers a thread.  Padded keys
// get the -1e30 bias, keys past Tk -inf; rows past Tq are not stored.
// Fill at batch 1, H 4 (one CTA per SM: 226 KB of shared memory): T 1536
// runs 96 CTAs on 96 of the 132 SMs, T 1024 64, T 768 48, T 512 32.
//
// At head dim 256 each consumer owns 128 columns: S over 2 blocks, O in
// 64 registers a thread (m64n128k16 with P from registers), 129 KB of
// shared memory; the CTA count at a shape is the same as at 512.  A
// design of its own for 256 (128 query rows a CTA, a deeper ring) is later
// work.
//
// f32 (parity checks): one block of 256 threads per (b, h, 32-query
// tile) on FMA units.  Q, K and V tiles are held as f32 (197 KB at
// D = 512); thread (r, l) owns query row r = tid / 8, computes keys
// l, l+8, l+16, l+24 of S with float4 dot products, reduces the row's max
// and sum over its 8 threads with shuffles, and accumulates columns
// 4l + 32j of the row's output in registers.
//
// Not yet used: overlap of the softmax with the next tile's S product
// (FlashAttention-3's ping-pong), a 2-CTA cluster splitting the head dim
// to fill the card at batch 1, TMA stores of O.
#include "common.cuh"
#include "hopper.cuh"

namespace {


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
// bf16 on Hopper: wgmma with TMA loads into a two-stage ring
// ---------------------------------------------------------------------------

namespace k1 {

// The design takes head dims 512 and 256 (a template on HD; 512 as it was
// designed, 256 the same layout with each consumer owning 128 columns).
constexpr int BQ = 64;                // query rows a CTA
constexpr int BKEY = 32;              // keys a stage
constexpr int STAGES = 2;
constexpr int QBOX = BQ * 128;        // 64 rows x 64 d, bytes
constexpr int KBOX = BKEY * 128;      // 32 rows x 64 d
constexpr int XCH = 2 * 2 * 128 * 16 * 4;   // S partials: parity x half
constexpr int THREADS = 384;

template <int HD>
struct Dims {
  static_assert(HD == 256 || HD == 512, "K1 takes head dims 256 and 512");
  static constexpr int NB = HD / 64;            // 64-column blocks
  static constexpr int CB = NB / 2;             // blocks a consumer owns
  static constexpr int Q_BYTES = NB * QBOX;     // 64 KB at 512
  static constexpr int KV_BYTES = NB * KBOX;    // 32 KB a K or V tile at 512
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE + XCH + 1024;
  static constexpr int ACC = HD / 4;            // O registers a thread
};

// one tensor's 4-D map holds (D, T, H, B) or (D, H, T, B), the order that
// keeps its strides increasing; bit `which` of `order` says (D, H, T, B)
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int order, int which,
                                          int d0, int t0, int h, int b) {
  if ((order >> which) & 1)
    hopper::tma_load_4d(dst, map, bar, d0, h, t0, b);
  else
    hopper::tma_load_4d(dst, map, bar, d0, t0, h, b);
}

// O += P V over this consumer's HD / 2 columns: m64n256k16 at 512,
// m64n128k16 at 256
template <int HD>
__device__ __forceinline__ void pv_product(float (&o)[HD / 4],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (HD == 512)
    hopper::wgmma_m64n256k16_rs<1>(o, a, db, 1);
  else
    hopper::wgmma_m64n128k16_rs<1>(o, a, db, 1);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, int order,
                      const float* __restrict__ mask,
                      __nv_bfloat16* __restrict__ out, long long osb,
                      long long osh, long long ost, float* __restrict__ lse,
                      int H, int Tq, int Tk, float scale) {
  using Dm = Dims<HD>;
  constexpr int NB = Dm::NB, CB = Dm::CB, Q_BYTES = Dm::Q_BYTES,
                KV_BYTES = Dm::KV_BYTES, STAGE = Dm::STAGE, ACC = Dm::ACC;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qfull, full[STAGES], empty[STAGES];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = qs + Q_BYTES;
  float4* xch = reinterpret_cast<float4*>(ring + STAGES * STAGE);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int nk = (Tk + BKEY - 1) / BKEY;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    hopper::setmaxnreg_dec<40>();
    if (tid == 0) {
      hopper::mbar_expect_tx(&qfull, Q_BYTES);
      for (int i = 0; i < NB; ++i)
        load_rows(qs + i * QBOX, &q_map, &qfull, order, 0, 64 * i, q0, h, b);
      int s = 0, ph = 0;
      for (int kt = 0; kt < nk; ++kt) {
        uint8_t* st = ring + s * STAGE;
        hopper::mbar_wait(&empty[s], ph ^ 1);
        hopper::mbar_expect_tx(&full[s], STAGE);
        for (int i = 0; i < NB; ++i) {
          load_rows(st + i * KBOX, &k_map, &full[s], order, 1, 64 * i,
                    kt * BKEY, h, b);
          load_rows(st + KV_BYTES + i * KBOX, &v_map, &full[s], order, 2,
                    64 * i, kt * BKEY, h, b);
        }
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns head-dim columns HD / 2 cw .. on ----
    hopper::setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int w = tid / 32, g = (tid % 32) / 4, t4 = tid % 4;
    const float* mb = mask ? mask + (long long)b * Tk : nullptr;
    float o[ACC];
#pragma unroll
    for (int e = 0; e < ACC; ++e) o[e] = 0.f;
    float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
    const uint32_t qa = hopper::smem_addr(qs + CB * cw * QBOX);
    hopper::mbar_wait(&qfull, 0);

    int s = 0, ph = 0;
    for (int kt = 0; kt < nk; ++kt) {
      uint8_t* st = ring + s * STAGE;
      hopper::mbar_wait(&full[s], ph);
      const uint32_t ka = hopper::smem_addr(st + CB * cw * KBOX);
      const uint32_t va = hopper::smem_addr(st + KV_BYTES + CB * cw * KBOX);

      // this half's partial S = Q K^T over its HD / 2 columns
      float sc[16];
      hopper::wgmma_fence();
#pragma unroll
      for (int db = 0; db < CB; ++db)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_m64n32k16_ss<0, 0>(
              sc, hopper::desc_sw128(qa + db * QBOX + 32 * kk, 16, 1024),
              hopper::desc_sw128(ka + db * KBOX + 32 * kk, 16, 1024),
              (db | kk) != 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // the two halves swap partials through shared memory, so both
      // apply the same row max and sum (a + b == b + a in f32)
      float4* mine = xch + ((kt & 1) * 2 + cw) * 4 * 128;
      const float4* other = xch + ((kt & 1) * 2 + (1 - cw)) * 4 * 128;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mine[i * 128 + tid] = make_float4(sc[4 * i], sc[4 * i + 1],
                                          sc[4 * i + 2], sc[4 * i + 3]);
      hopper::named_barrier(1, 256);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = other[i * 128 + tid];
        sc[4 * i] += v.x;
        sc[4 * i + 1] += v.y;
        sc[4 * i + 2] += v.z;
        sc[4 * i + 3] += v.w;
      }

      // online softmax; element e is row 16 w + g + 8 ((e >> 1) & 1), key
      // 8 (e >> 2) + 2 t4 + (e & 1); a row's keys live in 4 lanes
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int key = kt * BKEY + 8 * (e >> 2) + 2 * t4 + (e & 1);
        const float bias =
            key < Tk ? (mb ? (1.f - mb[key]) * NEG_BIG : 0.f) : -INFINITY;
        sc[e] = sc[e] * scale + bias;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
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
      for (int e = 0; e < 16; ++e) {
        sc[e] = expf(sc[e] - m[(e >> 1) & 1]);
        psum[(e >> 1) & 1] += sc[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        l[r] = l[r] * corr[r] + psum[r];
      }
#pragma unroll
      for (int e = 0; e < ACC; ++e) o[e] *= corr[(e >> 1) & 1];

      // O += P V: P (rounded to bf16, as the Pallas kernel casts it to V's
      // type) from registers, V [key][d] MN-major, N = HD / 2
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint32_t a[4] = {
            serenade::pack_bf16(sc[8 * ks], sc[8 * ks + 1]),
            serenade::pack_bf16(sc[8 * ks + 2], sc[8 * ks + 3]),
            serenade::pack_bf16(sc[8 * ks + 4], sc[8 * ks + 5]),
            serenade::pack_bf16(sc[8 * ks + 6], sc[8 * ks + 7])};
        pv_product<HD>(o, a, hopper::desc_sw128(va + ks * 2048, KBOX, 1024));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      if (tid == 0) hopper::mbar_arrive(&empty[s]);
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }

    // element e of O: row 16 w + g + 8 ((e >> 1) & 1), column
    // HD / 2 cw + 8 (e >> 2) + 2 t4 + (e & 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * w + g + 8 * r;
      if (row >= Tq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      const float inv = 1.f / denom;
      __nv_bfloat16* orow =
          out + b * osb + h * osh + row * ost + HD / 2 * cw + 2 * t4;
#pragma unroll
      for (int i = 0; i < ACC / 4; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) = serenade::pack_bf16(
            o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      if (cw == 0 && t4 == 0)
        lse[((long long)b * H + h) * Tq + row] = m[r] + logf(denom);
    }
  }
}

}  // namespace k1

}  // namespace

// The caller plans the launch (ops/flash_cuda.py k1_plan): grid
// (grid_x, H, B), `threads` a CTA and `smem` bytes of dynamic shared
// memory.  A plan that does not match the kernel's own rows a CTA, threads
// and shared memory returns cudaErrorInvalidValue.
extern "C" int serenade_flash_fwd(
    const void* q, long long qsb, long long qsh, long long qst, const void* k,
    long long ksb, long long ksh, long long kst, const void* v, long long vsb,
    long long vsh, long long vst, const float* mask, void* out, long long osb,
    long long osh, long long ost, float* lse, int B, int H, int Tq, int Tk,
    int D, float scale, int dtype, int grid_x, int threads, int smem,
    cudaStream_t stream) {
  if (D % 32 != 0 || D > MAX_D || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, H, B);
  if (dtype == 1) {
    if ((D != 256 && D != 512) || grid_x != (Tq + k1::BQ - 1) / k1::BQ ||
        threads != k1::THREADS ||
        smem != (D == 512 ? k1::Dims<512>::SMEM : k1::Dims<256>::SMEM))
      return (int)cudaErrorInvalidValue;
    // (D, T, H, B) or (D, H, T, B) maps, whichever keeps the strides
    // increasing; the (B, H, T, D) views of (B, T, H, D) buffers take the
    // second.  Boxes of 64 columns x 64 (Q) or 32 (K, V) rows.
    CUtensorMap maps[3];
    const void* ptrs[3] = {q, k, v};
    const long long sb[3] = {qsb, ksb, vsb}, sh[3] = {qsh, ksh, vsh},
                    stt[3] = {qst, kst, vst};
    const int rows[3] = {k1::BQ, k1::BKEY, k1::BKEY};
    const int lens[3] = {Tq, Tk, Tk};
    int order = 0;
    for (int i = 0; i < 3; ++i) {
      const bool h_inner = sh[i] < stt[i];
      order |= (int)h_inner << i;
      const cuuint64_t dims[4] = {
          (cuuint64_t)D, (cuuint64_t)(h_inner ? H : lens[i]),
          (cuuint64_t)(h_inner ? lens[i] : H), (cuuint64_t)B};
      const cuuint64_t strides[3] = {
          2ull * (h_inner ? sh[i] : stt[i]), 2ull * (h_inner ? stt[i] : sh[i]),
          2ull * sb[i]};
      const cuuint32_t box[4] = {64, h_inner ? 1u : (cuuint32_t)rows[i],
                                 h_inner ? (cuuint32_t)rows[i] : 1u, 1};
      const int e = hopper::encode_map_bf16(&maps[i], ptrs[i], 4, dims,
                                            strides, box);
      if (e) return e;
    }
    auto kernel = D == 512 ? k1::flash_fwd_bf16_kernel<512>
                           : k1::flash_fwd_bf16_kernel<256>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, threads, smem, stream>>>(
        maps[0], maps[1], maps[2], order, mask,
        static_cast<__nv_bfloat16*>(out), osb, osh, ost, lse, H, Tq, Tk,
        scale);
  } else if (dtype == 0) {
    if (grid_x != (Tq + BQ - 1) / BQ || threads != THREADS ||
        (size_t)smem != sizeof(float) * ((size_t)(BQ + BK) * (D + 4) +
                                         (size_t)BK * D +
                                         (size_t)BQ * (BK + 1)))
      return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    flash_fwd_f32_kernel<<<grid, threads, smem, stream>>>(
        static_cast<const float*>(q), qsb, qsh, qst,
        static_cast<const float*>(k), ksb, ksh, kst,
        static_cast<const float*>(v), vsb, vsh, vst, mask,
        static_cast<float*>(out), osb, osh, ost, lse, H, Tq, Tk, D, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
