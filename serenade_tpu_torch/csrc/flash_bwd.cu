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
// K4, bf16 (the training path), designed for Hopper; head_dim 512 only
// (ops/flash_cuda.py k4_plan raises on another).  One CTA of 384 threads
// per 64 query rows of one (b, h) keeps Q and dO resident (64 KB each,
// loaded once) and walks 32-key tiles of K and V through a ring of five
// 16 KB slots, each half a tile (256 columns); with the dS tile that is
// 216 KB of the 227.  The 64 x 512 f32 dQ accumulator takes 128 KB of
// registers, so the roles are split as in K5:
//   warpgroup 0 computes S = Q K^T and dP = dO V^T (wgmma m64n32k16 over D
//   512), P = exp(S scale + bias - L) and dS = P (dP - D) scale, and
//   writes dS as bf16 [query][key] rows, 128-byte swizzled (K-major A);
//   warpgroups 1 and 2 accumulate dQ[:, 0:256] and dQ[:, 256:512] += dS K
//   (wgmma m64n256k16, B the K half [key][d] MN-major through the
//   descriptor's transpose bit), 128 registers a thread each.
// Tile t + 1's S and dP overlap tile t's dQ products.  Five slots hold one
// tile and a half (Slots): as warpgroup 0 finishes dP, the consumers
// refill its two V halves with the next tile's second K half and first V
// half, and after their dQ products each refills its own K half (the next
// tile's second V half, the tile after next's first K half), each where
// its warpgroup has no product in flight; warpgroup 0 issues no load after
// the first tile.  The warpgroups signal each other through named
// barriers (an mbarrier's waiter woke up to 0.4 us after the arrival).
// The rules K5 learned hold: warp-uniform roles, a wgmma fence after every
// wait.  The epilogue stages dQ through the Q and dO tiles and stores 16
// bytes a thread in the (B, Tq, H, D) layout.  At (16, 4, 512, 512) it
// takes about 0.15 ms against a bound of 0.05 ms (PERF.md): m64n32
// products read 3 KB of shared memory for 64 K operations, so S and dP,
// the refills and dQ together keep shared memory near its rate (NVIDIA
// H100 80GB HBM3, 700 W).
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
// Not yet used: in K4 and K5 a 2-CTA cluster splitting the head dim, which
// would make room for more stages; in K5 a second Q / dO stage (no room
// at D 512).  Tried in K5 and slower (PERF.md):
// a TMA multicast of each Q and dO tile to a cluster of two key blocks, a
// 13th warp issuing the loads (ptxas then allows 128 registers a thread).
#include "common.cuh"
#include "hopper.cuh"

namespace {


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
// K4 bf16 on Hopper: wgmma, TMA, warp specialisation
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

namespace k4 {

constexpr int HD = 512;               // the head dim this design takes
constexpr int BQ = 64;                // queries a CTA
constexpr int BKEY = 32;              // keys a tile
constexpr int THREADS = 384;
constexpr int SLOTS = 5;              // half tiles of K or V in the ring
constexpr int QBOX = BQ * 128;        // 64 rows x 64 d, bytes
constexpr int KBOX = BKEY * 128;      // 32 rows x 64 d
constexpr int TILE = 8 * QBOX;        // Q or dO, 64 KB
constexpr int HALF = 4 * KBOX;        // 256 columns of a K or V tile, 16 KB
constexpr int OFF_Q = 0, OFF_G = TILE, OFF_SLOT = 2 * TILE;
constexpr int OFF_DS = OFF_SLOT + SLOTS * HALF;
// dS as [query][key] rows of 128 bytes (keys 0-31 in the first 64 bytes)
constexpr int SMEM = OFF_DS + BQ * 128 + 1024;   // + alignment
// the epilogue stages each consumer's 64 x 256 dQ block as rows padded by
// 16 bytes, the first consumer's in the Q tile and the second's in dO's
constexpr int OUT_LD = 256 * 2 + 16;
static_assert(BQ * OUT_LD <= TILE, "a staged dQ block fits in its tile");

// The slots of one key tile's four halves: K's columns 0-255 (ka) and
// 256-511 (kb), V's (va, vb), and the slot that already holds the next
// tile's ka (nxt).  The ring refills each slot once its half is consumed:
// va with the next tile's kb and vb with its va (warpgroup 0, after dP),
// ka with the next tile's vb (warpgroup 1, after its dQ products) and kb
// with the ka of the tile after next (warpgroup 2).  So the next tile's
// slots are these, permuted.
struct Slots {
  int ka, kb, va, vb, nxt;
  __device__ __forceinline__ Slots next() const {
    return {nxt, va, vb, ka, kb};
  }
  __device__ __forceinline__ uint32_t mask() const {
    return (1u << ka) | (1u << kb) | (1u << va) | (1u << vb);
  }
};

// the half `half` (four 64-column blocks, one TMA instruction) of the K or
// V tile at keys k0 into slot s; called by one thread
__device__ __forceinline__ void load_half(uint8_t* ring, int s,
                                          const CUtensorMap* map,
                                          uint64_t* full, int k0, int half,
                                          int h, int b) {
  hopper::mbar_expect_tx(&full[s], HALF);
  hopper::tma_load_blocks(ring + s * HALF, map, &full[s], k0, 4 * half, h, b);
}

// the key mask at key t of a sample's row `mb` (1 without a mask), from
// key min(t, Tk - 1).  The load is volatile, so it is issued where it
// stands: the compiler would otherwise move it to its use a tile later
// and stall there for the memory's latency.
__device__ __forceinline__ float mask_at(const float* mb, int t, int Tk) {
  if (!mb) return 1.f;
  float m;
  asm volatile("ld.global.nc.f32 %0, [%1];\n"
               : "=f"(m)
               : "l"(mb + min(t, Tk - 1)));
  return m;
}

// acc (64 queries x 32 keys) = rows (Q or dO) x the tile (K or V) over the
// head dim: columns 0-255 from slot s0, 256-511 from s1, each as it lands.
// After each wait the products are fenced anew: the wait is a loop, and
// without the fence ptxas puts its own on the loop's path and serialises
// every product.
__device__ __forceinline__ void scores(float (&acc)[16], uint32_t rows,
                                       uint32_t ring, uint64_t* full,
                                       int s0, int s1, uint32_t par) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = half ? s1 : s0;
    const uint32_t keys = ring + s * HALF;
    hopper::mbar_wait(&full[s], (par >> s) & 1);
    hopper::wgmma_fence();
    hopper::fence_regs(acc);
#pragma unroll
    for (int db = 0; db < 4; ++db)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n32k16_ss<0, 0>(
            acc,
            hopper::desc_sw128(rows + (4 * half + db) * QBOX + 32 * kk, 16,
                               1024),
            hopper::desc_sw128(keys + db * KBOX + 32 * kk, 16, 1024),
            (half | db | kk) != 0);
    hopper::wgmma_commit();
    hopper::fence_regs(acc);
  }
}

// Named barriers between the warpgroups (hardware barriers: an mbarrier's
// waiter wakes up to 0.4 us after the arrival, which sat on the critical
// path; PERF.md): warpgroup 0 has freed the V halves (one each for the
// refilling warps 0 of warpgroups 1 and 2), dS is in shared memory, the
// consumers are done with it; and each consumer's epilogue.
constexpr int BAR_VA = 4, BAR_VB = 5, BAR_DS_READY = 6, BAR_DS_FREE = 7;
constexpr int BAR_EPILOGUE = 2;   // + the consumer's index

__global__ void __launch_bounds__(THREADS, 1)
dq_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap g_map,
               const float* __restrict__ mask, const float* __restrict__ lse,
               const float* __restrict__ dsum, Out dq, int H, int Tq, int Tk,
               float scale) {
  extern __shared__ uint8_t smem_raw[];
  // qfull / gfull: the Q and dO tiles have landed; full: a slot has
  __shared__ __align__(8) uint64_t qfull, gfull, full[SLOTS];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = sm + OFF_SLOT;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  // the warpgroup and the warp in it, from lane 0: values ptxas knows are
  // the same in every thread of a warp, so that a branch on them is not
  // divergent (a wgmma on a divergent path is serialised)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int w = __shfl_sync(0xffffffffu, threadIdx.x % 128 / 32, 0);
  const int tid = threadIdx.x % 128;
  const int g8 = (tid % 32) / 4, t4 = tid % 4;
  const int nk = (Tk + BKEY - 1) / BKEY;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&qfull, 1);
    hopper::mbar_init(&gfull, 1);
    for (int s = 0; s < SLOTS; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const uint32_t base = hopper::smem_addr(sm);
  const uint32_t rbase = base + OFF_SLOT;
  Slots s{0, 1, 2, 3, 4};
  uint32_t par = 0;   // bit i: the parity of slot i's current fill

  if (wg == 0) {
    // ---- warpgroup 0: S = Q K^T and dP = dO V^T (wgmma m64n32k16 over the
    // head dim; element e is query 16 w + g8 + 8 ((e >> 1) & 1), key
    // 8 (e >> 2) + 2 t4 + (e & 1)), P and dS.  Its thread 0 issues the
    // loads of Q, dO, the first tile and the next tile's first K half.
    if (tid == 0) {
      hopper::prefetch_map(&q_map);
      hopper::prefetch_map(&k_map);
      hopper::prefetch_map(&v_map);
      hopper::prefetch_map(&g_map);
      hopper::mbar_expect_tx(&qfull, TILE);
      hopper::mbar_expect_tx(&gfull, TILE);
      for (int half = 0; half < 2; ++half) {
        hopper::tma_load_blocks(sm + OFF_Q + 4 * half * QBOX, &q_map, &qfull,
                                q0, 4 * half, h, b);
        hopper::tma_load_blocks(sm + OFF_G + 4 * half * QBOX, &g_map, &gfull,
                                q0, 4 * half, h, b);
      }
      load_half(ring, s.ka, &k_map, full, 0, 0, h, b);
      load_half(ring, s.kb, &k_map, full, 0, 1, h, b);
      load_half(ring, s.va, &v_map, full, 0, 0, h, b);
      load_half(ring, s.vb, &v_map, full, 0, 1, h, b);
      if (nk > 1) load_half(ring, s.nxt, &k_map, full, BKEY, 0, h, b);
    }
    const long long row0 = ((long long)b * H + h) * Tq;
    const float* mb = mask ? mask + (long long)b * Tk : nullptr;
    float L[2], D[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 16 * w + g8 + 8 * r;
      L[r] = q < Tq ? lse[row0 + q] : INFINITY;   // P = 0 past Tq
      D[r] = q < Tq ? dsum[row0 + q] : 0.f;
    }
    // the key mask at this thread's keys 8 (i / 2) + 2 t4 + i % 2 of a
    // tile, read a tile ahead (past Tk: the last key's, unused)
    float km[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      km[i] = mask_at(mb, 8 * (i / 2) + 2 * t4 + i % 2, Tk);
    hopper::mbar_wait(&qfull, 0);
    hopper::mbar_wait(&gfull, 0);
    for (int j = 0; j < nk; ++j) {
      const int k0 = j * BKEY;
      float kbias[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = k0 + 8 * (i / 2) + 2 * t4 + i % 2;
        kbias[i] = t < Tk ? (1.f - km[i]) * NEG_BIG : -INFINITY;
        km[i] = mask_at(mb, t + BKEY, Tk);
      }
      float sc[16], dp[16];
      scores(sc, base + OFF_Q, rbase, full, s.ka, s.kb, par);
      scores(dp, base + OFF_G, rbase, full, s.va, s.vb, par);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      // V is free (this warpgroup was its only reader): the consumers
      // refill it
      if (j + 1 < nk) {
        hopper::named_arrive(BAR_VA, 160);
        hopper::named_arrive(BAR_VB, 160);
      }
      // dS = P (dP - D) scale with P = exp(S scale + key bias - L), cast to
      // bf16 as JAX casts it to K's type, into [query][key] rows, 128-byte
      // swizzled: the K-major A operand of dQ += dS K.  The consumers must
      // be done with the last tile's.
      if (j > 0) hopper::named_barrier(BAR_DS_FREE, 384);
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        const int r = (e >> 1) & 1;
        const int q = 16 * w + g8 + 8 * r;
        const int key = 8 * (e >> 2) + 2 * t4;
        const float p0 = expf(sc[e] * scale + kbias[2 * (e >> 2)] - L[r]);
        const float p1 =
            expf(sc[e + 1] * scale + kbias[2 * (e >> 2) + 1] - L[r]);
        *reinterpret_cast<uint32_t*>(sm + OFF_DS + hopper::sw128(q, 2 * key)) =
            serenade::pack_bf16(p0 * (dp[e] - D[r]) * scale,
                                p1 * (dp[e + 1] - D[r]) * scale);
      }
      hopper::fence_async_shared();
      hopper::named_arrive(BAR_DS_READY, 384);
      par ^= s.mask();
      s = s.next();
    }
    return;
  }

  // ---- warpgroups 1 and 2: dQ[:, 256 cw .. + 255] += dS K[:, same] (wgmma
  // m64n256k16; A dS K-major, B the K half [key][d] MN-major through the
  // descriptor's transpose bit), 64 x 256 in 128 registers a thread.  The
  // thread 0 of each refills a V half warpgroup 0 freed and, after its
  // products, its own K half, where its warpgroup has no product in flight.
  const int cw = wg - 1;
  float acc[128];
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0.f;
  for (int j = 0; j < nk; ++j) {
    const int mine = cw ? s.kb : s.ka;
    // va takes the next tile's K columns 256-511, vb its V columns 0-255
    if (j + 1 < nk && w == 0) {
      hopper::named_barrier(BAR_VA + cw, 160);
      if (tid == 0)
        load_half(ring, cw ? s.vb : s.va, cw ? &v_map : &k_map, full,
                  (j + 1) * BKEY, cw ? 0 : 1, h, b);
    }
    hopper::named_barrier(BAR_DS_READY, 384);
    hopper::mbar_wait(&full[mine], (par >> mine) & 1);   // warpgroup 0 saw it
    hopper::wgmma_fence();
    hopper::fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      hopper::wgmma_m64n256k16_ss<0, 1>(
          acc, hopper::desc_sw128(base + OFF_DS + 32 * ks, 16, 1024),
          hopper::desc_sw128(rbase + mine * HALF + 2048 * ks, KBOX, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (j + 1 < nk) hopper::named_arrive(BAR_DS_FREE, 384);
    // ka takes the next tile's V columns 256-511, kb the K columns 0-255
    // of the tile after next
    const int ahead = cw ? 2 : 1;
    if (tid == 0 && j + ahead < nk)
      load_half(ring, mine, cw ? &k_map : &v_map, full, (j + ahead) * BKEY,
                cw ? 0 : 1, h, b);
    par ^= s.mask();
    s = s.next();
  }

  // epilogue: dQ through shared memory (the Q or dO tile: warpgroup 0 is
  // done with both) to (B, Tq, H, D) rows, 16 bytes a store.  Element e of
  // acc is query 16 w + g8 + 8 ((e >> 1) & 1), column 8 (e >> 2) + 2 t4 +
  // (e & 1) of this consumer's 256.
  uint8_t* own = sm + (cw ? OFF_G : OFF_Q);
#pragma unroll
  for (int e = 0; e < 128; e += 2) {
    const int q = 16 * w + g8 + 8 * ((e >> 1) & 1);
    const int c = 8 * (e >> 2) + 2 * t4;
    *reinterpret_cast<uint32_t*>(own + q * OUT_LD + 2 * c) =
        serenade::pack_bf16(acc[e], acc[e + 1]);
  }
  hopper::named_barrier(BAR_EPILOGUE + cw, 128);
  for (int c = tid; c < BQ * 32; c += 128) {
    const int q = c / 32, ch = c % 32;
    if (q0 + q < Tq)
      *reinterpret_cast<uint4*>(static_cast<bf16*>(dq.p) + b * dq.sb +
                                h * dq.sh + (long long)(q0 + q) * dq.st +
                                256 * cw + 8 * ch) =
          *reinterpret_cast<const uint4*>(own + q * OUT_LD + 16 * ch);
  }
}

}  // namespace k4

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
    // TMA: 16-byte aligned bases and strides
    const long long st[] = {a.qsb, a.qsh, a.qst, a.ksb, a.ksh, a.kst,
                            a.vsb, a.vsh, a.vst, a.gsb, a.gsh, a.gst};
    for (long long s : st)
      if (s % 8) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<size_t>(a.q) | reinterpret_cast<size_t>(a.k) |
         reinterpret_cast<size_t>(a.v) | reinterpret_cast<size_t>(a.g)) % 16)
      return (int)cudaErrorInvalidValue;
  } else if (dtype != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// 5-D maps (hopper::encode_heads_blocks) over the strided (B, H, T, D)
// views of q, k, v and dO, in that order: boxes of 64 columns x `qrows`
// rows x 4 column blocks (half a Q or dO tile) and of 64 columns x
// `krows` rows x `kblocks` blocks for K and V
int encode_maps(CUtensorMap (&maps)[4], const Heads& a, int B, int qrows,
                int krows, int kblocks) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.g};
  const long long sb[4] = {a.qsb, a.ksb, a.vsb, a.gsb},
                  sh[4] = {a.qsh, a.ksh, a.vsh, a.gsh},
                  st[4] = {a.qst, a.kst, a.vst, a.gst};
  const int rows[4] = {qrows, krows, krows, qrows};
  const int blocks[4] = {4, kblocks, kblocks, 4};
  const int lens[4] = {a.Tq, a.Tk, a.Tk, a.Tq};
  for (int i = 0; i < 4; ++i) {
    const int e = hopper::encode_heads_blocks(&maps[i], ptrs[i], sb[i], sh[i],
                                              st[i], B, a.H, lens[i], a.D,
                                              rows[i], blocks[i]);
    if (e) return e;
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

// The caller plans the launch (ops/flash_cuda.py k4_plan): grid
// (grid_x, H, B), `threads` a CTA and `smem` bytes of dynamic shared
// memory.  bf16 takes head_dim 512 only, on the Hopper kernel; a plan that
// does not match either kernel's own query rows a CTA, threads and shared
// memory returns cudaErrorInvalidValue.
extern "C" int serenade_flash_bwd_dq(SERENADE_HEAD_ARGS, void* dq,
                                     long long dsb, long long dsh,
                                     long long dst, int B, int H, int Tq,
                                     int Tk, int D, float scale, int dtype,
                                     int grid_x, int threads, int smem,
                                     cudaStream_t stream) {
  const Heads a = make_heads(q, qsb, qsh, qst, k, ksb, ksh, kst, v, vsb, vsh,
                             vst, mask, g, gsb, gsh, gst, lse, dsum, H, Tq,
                             Tk, D, scale);
  const int bad = check_args(a, B, dtype);
  if (bad) return bad;
  const Out o{dq, dsb, dsh, dst};
  if (dtype == 1) {
    // 16-byte stores of dQ rows
    if (dsb % 8 || dsh % 8 || dst % 8 || reinterpret_cast<size_t>(dq) % 16 ||
        D != k4::HD || grid_x != (Tq + k4::BQ - 1) / k4::BQ ||
        threads != k4::THREADS || smem != k4::SMEM)
      return (int)cudaErrorInvalidValue;
    CUtensorMap maps[4];
    const int e = encode_maps(maps, a, B, k4::BQ, k4::BKEY, 4);
    if (e) return e;
    return launch(k4::dq_bf16_kernel, dim3(grid_x, H, B), threads, smem,
                  stream, maps[0], maps[1], maps[2], maps[3], mask, lse, dsum,
                  o, H, Tq, Tk, scale);
  }
  if (grid_x != (Tq + F_T - 1) / F_T || threads != F_THREADS ||
      (size_t)smem !=
          sizeof(float) * ((size_t)4 * F_T * (D + 1) + F_T * (F_T + 1)))
    return (int)cudaErrorInvalidValue;
  return launch(dq_f32_kernel, dim3(grid_x, H, B), threads, smem, stream, a,
                o);
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
    // Q and dO by halves (four 64-column blocks), K and V whole
    CUtensorMap maps[4];
    const int e = encode_maps(maps, a, B, k5::BQ, k5::BKEY, 8);
    if (e) return e;
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
