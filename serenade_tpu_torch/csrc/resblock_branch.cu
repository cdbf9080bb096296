// K3: the convolutions of a HiFiGAN residual branch.
//
// Replaces serenade_tpu/ops/resblock_pallas.py:154 (resblock_branch_pallas
// -> _branch_kernel): per dilation d, h += conv_k(lrelu(conv_k,d(lrelu(h)))),
// lrelu slope 0.1, with zeros outside [0, T) before every conv (torch
// "same" padding, the edge-tile semantics of resblock_pallas.py:58-63).
//
// What bounds it on the H100: a stage at C 256, k 11, T 8192 is two convs
// of 2 T k C^2 = 11.8 GFLOP each, 23.6 GFLOP, against 17 MB of f32
// activations; one 1024-frame conversion runs 9 branches of 3 stages,
// about 592 GFLOP (C 256, T 8192: 135; C 128, T 49152: 203; C 64,
// T 245760: 254).  Every level is bound by operations: at C 64 a conv
// does 22 GFLOP against 126 MB, 175 FLOP a byte, far past the card's
// ridge.  On the FMA units (67 TFLOP/s) the conversion's K3 work takes at
// least 8.8 ms, however good the kernel; only the tensor cores go lower.
//
// Design (f32, the vocoder's type), for Hopper.  The vocoder must stay
// f32: one TF32 product keeps about three decimal digits, 10 mantissa
// bits, and misses the 1e-4 that the plain f32 version is held to.  So
// every product is split TF32 ("3xTF32"): a = a_hi + a_lo and w = w_hi +
// w_lo, each part a TF32 value (rounded to nearest), and a w is taken as
// a_lo w_hi + a_hi w_lo + a_hi w_hi, accumulated in f32 by wgmma
// m64nNk8.f32.tf32.tf32; the dropped a_lo w_lo is about 2^-22 of a w.
// The tensor cores' f32 sums add a small bias with each product, so the
// error grows with a conv's depth C k: about 3e-5 of max(1, |ref|) at
// C 256, k 11 on an H100, against about 1e-6 for f32 adds in order.
// That is three tensor-core products for each f32 one: 592 GFLOP become
// 1.8 PFLOP of TF32 work, at least 3.6 ms a conversion at 495 TFLOP/s.
//   - One launch per conv: conv1 (dilation d) writes its f32 output to
//     global memory (L2 at the first level), conv2 reads it back and adds
//     the residual.  Keeping conv1's window in shared memory, as the FMA
//     kernel below does, leaves no room for a weight ring at C 256: the
//     two f32 windows alone take 259 KB at 64 rows.  The extra traffic is
//     one write and one read of the stage's activations, 126 MB a stage
//     at C 64, T 245760 (about 40 us at 3.35 TB/s against about 0.4 ms of
//     products).
//   - A CTA of 384 threads takes BM time rows x all C output channels.
//     Its two consumer warpgroups (setmaxnreg 232) first copy the input
//     window, rows t0 - p .. t0 + BM + p (p = (k - 1) / 2 dilation), into
//     shared memory by 16-byte cp.async, zeros outside [0, T), and apply
//     the lrelu in place; rows are padded to C + 4 floats, so a warp's
//     fragment loads hit 32 distinct banks.  A takes its fragments from
//     registers: tap j of output row r is window row r + j dilation, any
//     shift, with no swizzle atom to respect.  Each fragment element is
//     split into hi and lo by cvt.rna.tf32 as it is loaded.
//   - B, the weights, lie as (tap, hi/lo, Cout, Cin) with Cin contiguous,
//     K-major as TF32 wgmma requires (its transpose bits exist for 16-bit
//     types only), split once per weight version on the host
//     (ops/resblock_cuda.py).  Warpgroup 0 keeps a ring of stages full by
//     TMA: a stage is one tap and 16 input channels, hi and lo boxes of
//     C rows x 64 bytes with 64-byte swizzle, completed through mbarriers.
//   - The planner (ops/resblock_cuda.py k3_plan) picks the tile: at C 256
//     the two consumers split the columns (64 rows x 128 columns each, 64
//     accumulator registers), so T 8192 gives 128 CTAs for 132 SMs; at
//     C 128 and below they split the rows and each owns MB blocks of 64
//     rows (BM up to 256 at C 64, 512 at C 32 and 16: no more than 168
//     registers a thread, the budget of 384 threads, or ptxas spills).
//     The C entry checks the plan against the kernel's constants.
// bf16 branches, and f32 ones at a width the TF32 kernel does not take
// (C not 16, 32, 64, 128 or 256), run the FMA kernel below: one launch per
// dilation stage, the f32 input window and conv1's output window in
// shared memory, weights streamed from L2 in 16-channel tiles, an 8 x 8
// register tile per thread.
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

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

// f32 on Hopper's tensor cores by split TF32: one conv of a stage, out =
// [res +] bias + conv_{k, dil}(lrelu(x)), zeros outside [0, T) before the
// conv.  A CTA per (BM rows, sample); warpgroup 0 loads the weight ring,
// warpgroups 1 and 2 each own MB blocks of 64 rows x WN columns.
namespace k3 {

constexpr int THREADS = 384;
constexpr int KC = 16;            // input channels a stage: 64-byte rows
constexpr int MAX_STAGES = 8;
constexpr int LD_PAD = 4;         // floats of padding a window row
// dynamic shared memory a CTA may ask for: the card's 232,448 bytes less
// 1 KB for the static barriers
constexpr int SMEM_LIMIT = 232448 - 1024;

// bytes of one weight stage: hi and lo boxes of C rows x KC floats
__host__ __device__ constexpr int stage_bytes(int C) { return 2 * C * KC * 4; }

// dynamic shared memory of a plan: the ring (1024-aligned), then the
// window, plus 1 KB for the alignment of the ring
__host__ __device__ inline int smem_bytes(int C, int rows, int stages) {
  return stages * stage_bytes(C) + rows * (C + LD_PAD) * 4 + 1024;
}

// The A fragments of one step, split into TF32 hi and lo, for both K
// steps of 8 channels and the MB row blocks: `a` points at the thread's
// first element (row 16 w + g, column t of the block's window), `off` at
// the step's tap row and channels.
template <int MB>
__device__ __forceinline__ void load_frags(uint32_t (&ah)[2][MB][4],
                                           uint32_t (&al)[2][MB][4],
                                           const float* a, int ld, int off) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const float* p = a + off + 64 * m * ld + 8 * ks;
      const float v[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ah[ks][m][q] = hopper::to_tf32(v[q]);
        al[ks][m][q] = hopper::to_tf32(v[q] - __uint_as_float(ah[ks][m][q]));
      }
    }
}

// Waits for the step's weight stage, then issues its products: for each
// K step and row block the small terms a_lo w_hi and a_hi w_lo, then
// a_hi w_hi, into the f32 accumulators (one commit group).
template <int WN, int MB>
__device__ __forceinline__ void products(float (&acc)[MB][WN / 2],
                                         const uint32_t (&ah)[2][MB][4],
                                         const uint32_t (&al)[2][MB][4],
                                         uint64_t* full, int ph,
                                         const uint8_t* stage, int SB,
                                         int c0) {
  hopper::mbar_wait(full, ph);
  const uint32_t bh = hopper::smem_addr(stage) + c0 * KC * 4;
  const uint32_t bl = bh + SB / 2;
  hopper::wgmma_fence();
#pragma unroll
  for (int m = 0; m < MB; ++m) hopper::fence_regs(acc[m]);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const uint64_t dh = hopper::desc_sw64(bh + 32 * ks, 512);
    const uint64_t dl = hopper::desc_sw64(bl + 32 * ks, 512);
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      hopper::wgmma_tf32_rs<WN>(acc[m], al[ks][m], dh);
      hopper::wgmma_tf32_rs<WN>(acc[m], ah[ks][m], dl);
      hopper::wgmma_tf32_rs<WN>(acc[m], ah[ks][m], dh);
    }
  }
  hopper::wgmma_commit();
#pragma unroll
  for (int m = 0; m < MB; ++m) hopper::fence_regs(acc[m]);
}

// Waits for the step's products, hands its stage back to the producer and
// moves to the next stage of the ring.
template <int MB, int R>
__device__ __forceinline__ void retire(float (&acc)[MB][R], uint64_t* empty,
                                       int tid, int& s, int& ph,
                                       int stages) {
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MB; ++m) hopper::fence_regs(acc[m]);
  if (tid == 0) hopper::mbar_arrive(empty);
  if (++s == stages) {
    s = 0;
    ph ^= 1;
  }
}

template <int WN, int MB>
__global__ void __launch_bounds__(THREADS, 1)
conv_tf32_kernel(const __grid_constant__ CUtensorMap w_map,
                 const float* __restrict__ x, const float* __restrict__ bias,
                 const float* __restrict__ res, float* __restrict__ out,
                 int Tlen, int C, int k, int dil, int ns, int stages) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int SB = stage_bytes(C);
  const int BM = 64 * MB * (2 / ns);
  const int p = (k - 1) / 2 * dil;
  const int rows = BM + 2 * p;
  const int ld = C + LD_PAD;
  float* win = reinterpret_cast<float*>(ring + stages * SB);
  const int b = blockIdx.y, t0 = blockIdx.x * BM;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n_chunks = C / KC, n_steps = k * n_chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: step i is tap i / n_chunks, channels 16 (i % n_chunks)
    hopper::setmaxnreg_dec<40>();
    if (tid == 0) {
      int s = 0, ph = 0;
      for (int i = 0; i < n_steps; ++i) {
        const int j = i / n_chunks, ci0 = (i % n_chunks) * KC;
        uint8_t* st = ring + s * SB;
        hopper::mbar_wait(&empty[s], ph ^ 1);
        hopper::mbar_expect_tx(&full[s], SB);
        // rows (2 j) C .. and (2 j + 1) C .. of the (tap, hi/lo, Cout) rows
        hopper::tma_load_2d(st, &w_map, &full[s], ci0, 2 * j * C);
        hopper::tma_load_2d(st + SB / 2, &w_map, &full[s], ci0,
                            (2 * j + 1) * C);
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers ----
  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;
  // the window, lrelu'd, zeros outside [0, T); each thread applies the
  // lrelu to the 16-byte pieces it copied itself
  const float* xb = x + (size_t)b * Tlen * C;
  const int pieces = C / 4;
  for (int e = 128 * cw + tid; e < rows * pieces; e += 256) {
    const int r = e / pieces, c4 = e - r * pieces;
    const int t = t0 - p + r;
    const bool ok = t >= 0 && t < Tlen;
    hopper::cp_async_16(win + r * ld + 4 * c4,
                        ok ? xb + (size_t)t * C + 4 * c4 : x, ok);
  }
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  for (int e = 128 * cw + tid; e < rows * pieces; e += 256) {
    const int r = e / pieces, c4 = e - r * pieces;
    float4* q = reinterpret_cast<float4*>(win + r * ld + 4 * c4);
    float4 v = *q;
    v.x = lrelu(v.x, 0.1f);
    v.y = lrelu(v.y, 0.1f);
    v.z = lrelu(v.z, 0.1f);
    v.w = lrelu(v.w, 0.1f);
    *q = v;
  }
  hopper::named_barrier(1, 256);

  // this warpgroup's tile: rows r0 .. r0 + 64 MB, columns c0 .. c0 + WN
  const int r0 = ns == 2 ? 0 : 64 * MB * cw;
  const int c0 = ns == 2 ? WN * cw : 0;
  const int w = tid / 32, g = (tid % 32) / 4, t4 = tid % 4;
  float acc[MB][WN / 2];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int e = 0; e < WN / 2; ++e) acc[m][e] = 0.f;

  // two sets of A fragments: the next step's are loaded and split while
  // this step's products run
  uint32_t ah0[2][MB][4], al0[2][MB][4], ah1[2][MB][4], al1[2][MB][4];
  // output row r of tap j reads window row r + j dil
  const float* arow = win + (r0 + 16 * w + g) * ld + t4;
  int s = 0, ph = 0;
  load_frags<MB>(ah0, al0, arow, ld, 0);
  for (int i = 0; i < n_steps; i += 2) {
    products<WN, MB>(acc, ah0, al0, &full[s], ph, ring + s * SB, SB, c0);
    if (i + 1 < n_steps)
      load_frags<MB>(ah1, al1, arow, ld,
                     (i + 1) / n_chunks * dil * ld + (i + 1) % n_chunks * KC);
    retire<MB>(acc, &empty[s], tid, s, ph, stages);
    if (i + 1 == n_steps) break;
    products<WN, MB>(acc, ah1, al1, &full[s], ph, ring + s * SB, SB, c0);
    if (i + 2 < n_steps)
      load_frags<MB>(ah0, al0, arow, ld,
                     (i + 2) / n_chunks * dil * ld + (i + 2) % n_chunks * KC);
    retire<MB>(acc, &empty[s], tid, s, ph, stages);
  }

  // epilogue: element e of a block is row 16 w + g + 8 ((e >> 1) & 1),
  // column 8 (e >> 2) + 2 t + (e & 1)
  const size_t base = (size_t)b * Tlen * C;
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int e = 0; e < WN / 2; e += 2) {
      const int t = t0 + r0 + 64 * m + 16 * w + g + 8 * ((e >> 1) & 1);
      const int co = c0 + 8 * (e >> 2) + 2 * t4;
      if (t >= Tlen) continue;
      const size_t o = base + (size_t)t * C + co;
      float2 v = make_float2(acc[m][e] + bias[co], acc[m][e + 1] + bias[co + 1]);
      if (res) {
        const float2 r = *reinterpret_cast<const float2*>(res + o);
        v.x += r.x;
        v.y += r.y;
      }
      *reinterpret_cast<float2*>(out + o) = v;
    }
}

template <int WN, int MB>
int launch(const CUtensorMap& map, const float* x, const float* bias,
           const float* res, float* out, int B, int Tlen, int C, int k,
           int dil, int ns, int grid_x, int stages, int smem,
           cudaStream_t stream) {
  const cudaError_t a = cudaFuncSetAttribute(
      conv_tf32_kernel<WN, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (a != cudaSuccess) return (int)a;
  conv_tf32_kernel<WN, MB><<<dim3(grid_x, B), THREADS, smem, stream>>>(
      map, x, bias, res, out, Tlen, C, k, dil, ns, stages);
  return (int)cudaGetLastError();
}

}  // namespace k3

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

// One split-TF32 conv: out (B, T, C) f32 = [res +] bias + conv of lrelu(x)
// with the k taps of `w` (k, 2, C, C): tap j's hi then lo parts, each
// (Cout, Cin) with Cin contiguous, TF32 values.  `res` may be null.  The
// caller plans the launch (ops/resblock_cuda.py k3_plan): wn columns and
// mb 64-row blocks a consumer warpgroup, ns = 2 when the two split the
// columns (else the rows), grid_x row tiles of 64 mb (2 / ns) rows, the
// ring's stages and the dynamic shared memory.  A plan that does not
// match the kernel's constants returns cudaErrorInvalidValue.
extern "C" int serenade_resblock_conv_tf32(
    const float* x, const float* w, const float* bias, const float* res,
    float* out, int B, int Tlen, int C, int k, int dil, int wn, int mb,
    int ns, int grid_x, int stages, int smem, cudaStream_t stream) {
  if (B <= 0 || Tlen <= 0 || k % 2 != 1 || dil <= 0 || (ns != 1 && ns != 2)
      || wn * ns != C || C % k3::KC || stages < 2 ||
      stages > k3::MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  const int bm = 64 * mb * (2 / ns);
  const int rows = bm + 2 * ((k - 1) / 2 * dil);
  if (grid_x != (Tlen + bm - 1) / bm ||
      smem != k3::smem_bytes(C, rows, stages) || smem > k3::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  // rows of (tap, hi/lo, Cout), Cin innermost; boxes of 16 Cin x C rows
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)(2 * k * C)};
  const cuuint64_t strides[1] = {4ull * C};
  const cuuint32_t box[2] = {(cuuint32_t)k3::KC, (cuuint32_t)C};
  const int e = hopper::encode_map(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                   CU_TENSOR_MAP_SWIZZLE_64B, w, 2, dims,
                                   strides, box);
  if (e) return e;
#define K3_LAUNCH(WN, MB)                                                   \
  if (wn == WN && mb == MB)                                                 \
    return k3::launch<WN, MB>(map, x, bias, res, out, B, Tlen, C, k, dil, ns, \
                              grid_x, stages, smem, stream);
  K3_LAUNCH(128, 1)
  K3_LAUNCH(64, 1)
  K3_LAUNCH(64, 2)
  K3_LAUNCH(32, 1)
  K3_LAUNCH(32, 2)
  K3_LAUNCH(32, 4)
  K3_LAUNCH(16, 1)
  K3_LAUNCH(16, 2)
  K3_LAUNCH(16, 4)
#undef K3_LAUNCH
  return (int)cudaErrorInvalidValue;
}
