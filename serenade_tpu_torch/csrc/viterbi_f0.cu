// Viterbi F0 trellis: a kernel of the port with no Pallas counterpart.
//
// The JAX package decodes the pYIN-style trellis of
// serenade_tpu/ops/f0.py:249 (viterbi_f0_select) with a lax.scan over
// frames (:301) and a reverse lax.scan backtrace (:314).  In eager
// PyTorch a frame loop would cost about five launches a 10 ms frame, so
// the whole trellis of a batch of rows is one launch here.
//
// States: K voiced candidates (emission em[t, j], log2 frequency lf[t, j])
// and one unvoiced state (emission voiced_bias, log2 frequency 0).  From
// state i at frame t-1 to state j at frame t the cost is
//   total[i, j] = (cost[i] + trans[i, j]) + em[t, j]
//   trans[i, j] = toc * |lf[t, j] - lf[t-1, i]|  if both are voiced,
//                 sc                             if exactly one is,
//                 0                              if neither is,
// in f32, in that order of operations (JAX's `step`, f0.py:291-297, whose
// products by 0 or 1 are exact), and cost[j] is the least total, the
// first i on ties as jnp.argmin takes it.
//
// Design: one warp per row, 1 <= K <= 31 candidates, so that each of the
// K+1 states has a lane: YIN's trellis has K = 5, Harvest's
// (serenade_tpu/ops/harvest.py:356) K = 16.  Lane j < K+1 holds state j's
// cost and log frequency in registers and reads the others' by
// __shfl_sync (the state count is a template parameter, so the shuffles
// and the 1 + K compares unroll without a branch between them); a chunk
// of frames' emissions and log frequencies is staged in shared memory by
// the whole warp (coalesced), and the chunk's back pointers (uint8) are
// written to global scratch (B, N, K+1) in one coalesced store.  The
// backtrace walks the chunks in reverse: the warp stages a chunk of back
// pointers, lane 0 follows them, and the warp stores the chunk's states.
// A chunk is 256 frames up to 17 states (38.25 KB of static shared
// memory at 17) and 128 frames above (36 KB at 32), under the 48 KB a
// block may hold statically.
//
// Bound: the recursion is serial in frames, so the kernel is bound by
// latency (a few shuffles, adds and compares a frame), not by the card's
// rates; its bytes (emissions and log frequencies read once, states
// written once) would take well under a microsecond.  Rows run in
// parallel, one warp each.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vit {

constexpr unsigned kFull = 0xffffffffu;

template <int S>
__global__ void __launch_bounds__(32)
viterbi_kernel(const float* __restrict__ em, const float* __restrict__ lf,
               uint8_t* __restrict__ bp, int64_t* __restrict__ states, int n,
               float voiced_bias, float toc, float sc) {
  static_assert(S >= 2 && S <= 32, "one lane a state");
  constexpr int k = S - 1;
  constexpr int kChunk = S <= 17 ? 256 : 128;  // frames staged at once
  __shared__ float s_em[kChunk * k];
  __shared__ float s_lf[kChunk * k];
  __shared__ uint8_t s_bp[kChunk * S];
  __shared__ int64_t s_states[kChunk];

  const int lane = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* emr = em + row * (size_t)n * k;
  const float* lfr = lf + row * (size_t)n * k;
  uint8_t* bpr = bp + row * (size_t)n * S;
  int64_t* str = states + row * (size_t)n;

  const bool voiced_j = lane < k;
  float cost = 0.f;   // this lane's state: cost of the best path into it
  float lf_j = 0.f;   // and its log2 frequency at the current frame

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int cn = min(kChunk, n - c0);
    __syncwarp();
    for (int i = lane; i < cn * k; i += 32) {
      s_em[i] = emr[(size_t)c0 * k + i];
      s_lf[i] = lfr[(size_t)c0 * k + i];
    }
    __syncwarp();
    for (int tt = 0; tt < cn; ++tt) {
      const float e_j = voiced_j ? s_em[tt * k + lane] : voiced_bias;
      const float l_j = voiced_j ? s_lf[tt * k + lane] : 0.f;
      if (c0 + tt == 0) {
        cost = e_j;
        lf_j = l_j;
        continue;
      }
      float best = INFINITY;
      int arg = 0;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const float c_i = __shfl_sync(kFull, cost, i);
        const float l_i = __shfl_sync(kFull, lf_j, i);
        const bool voiced_i = i < k;
        float tr = 0.f;
        if (voiced_i && voiced_j) {
          tr = __fmul_rn(toc, fabsf(__fsub_rn(l_j, l_i)));
        } else if (voiced_i != voiced_j) {
          tr = sc;
        }
        const float total = __fadd_rn(__fadd_rn(c_i, tr), e_j);
        if (total < best) {   // strict: the first i of equal totals
          best = total;
          arg = i;
        }
      }
      cost = best;
      lf_j = l_j;
      if (lane < S) s_bp[tt * S + lane] = (uint8_t)arg;
    }
    __syncwarp();
    for (int i = lane; i < cn * S; i += 32) bpr[(size_t)c0 * S + i] = s_bp[i];
  }

  // the best final state, the first of equal costs
  int state = 0;
  float best = INFINITY;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float c_i = __shfl_sync(kFull, cost, i);
    if (c_i < best) {
      best = c_i;
      state = i;
    }
  }

  // backtrace, chunk by chunk from the end; lane 0 carries the state
  const int last_c0 = ((n - 1) / kChunk) * kChunk;
  for (int c0 = last_c0; c0 >= 0; c0 -= kChunk) {
    const int cn = min(kChunk, n - c0);
    __syncwarp();
    for (int i = lane; i < cn * S; i += 32) s_bp[i] = bpr[(size_t)c0 * S + i];
    __syncwarp();
    if (lane == 0) {
      for (int tt = cn - 1; tt >= 0; --tt) {
        s_states[tt] = state;
        if (c0 + tt > 0) state = s_bp[tt * S + state];
      }
    }
    __syncwarp();
    for (int i = lane; i < cn; i += 32) str[c0 + i] = s_states[i];
  }
}

}  // namespace vit

// em, lf: (b, n, k) f32 contiguous; bp: (b, n, k + 1) uint8 scratch;
// states: (b, n) int64.  Returns cudaGetLastError() after the launch.
extern "C" int serenade_viterbi_f0(const float* em, const float* lf,
                                   uint8_t* bp, int64_t* states, int b, int n,
                                   int k, float voiced_bias, float toc,
                                   float sc, cudaStream_t stream) {
  if (b < 1 || n < 1) return (int)cudaErrorInvalidValue;
  switch (k + 1) {
#define VIT_CASE(S)                                                      \
  case S:                                                                \
    vit::viterbi_kernel<S><<<b, 32, 0, stream>>>(em, lf, bp, states, n,  \
                                                 voiced_bias, toc, sc);  \
    break;
    VIT_CASE(2) VIT_CASE(3) VIT_CASE(4) VIT_CASE(5) VIT_CASE(6)
    VIT_CASE(7) VIT_CASE(8) VIT_CASE(9) VIT_CASE(10) VIT_CASE(11)
    VIT_CASE(12) VIT_CASE(13) VIT_CASE(14) VIT_CASE(15) VIT_CASE(16)
    VIT_CASE(17) VIT_CASE(18) VIT_CASE(19) VIT_CASE(20) VIT_CASE(21)
    VIT_CASE(22) VIT_CASE(23) VIT_CASE(24) VIT_CASE(25) VIT_CASE(26)
    VIT_CASE(27) VIT_CASE(28) VIT_CASE(29) VIT_CASE(30) VIT_CASE(31)
    VIT_CASE(32)
#undef VIT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
