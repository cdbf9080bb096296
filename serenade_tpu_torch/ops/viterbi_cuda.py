"""The Viterbi F0 trellis, CUDA kernel ``csrc/viterbi_f0.cu``.

A kernel of the port with no Pallas counterpart: the JAX package decodes
this trellis with a ``lax.scan`` over frames and a reverse scan
(``serenade_tpu/ops/f0.py:301``, ``:314``), which XLA compiles into one
program; eagerly, a frame loop would cost several launches a 10 ms frame.
The kernel runs the whole trellis of a batch of rows in one launch, one
warp a row, the states in registers, back pointers in global scratch
(``csrc/viterbi_f0.cu`` states its design and bound).  CPU tensors run
``viterbi_states_plain``, the frame loop, in the same f32 order of
operations; the wrapper counts one launch per call on CUDA.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from serenade_tpu_torch.ops import _cuda

launches = 0   # wrapper calls that launched the kernel since the last reset

MAX_STATES = 32  # K + 1 states at most: one lane of the row's warp each


def viterbi_states_plain(emission_voiced, log_f0, *, voiced_bias: float,
                         transition_octave_cost: float,
                         switch_cost: float) -> torch.Tensor:
    """The trellis frame by frame: ``(B, N, K)`` emissions and log2
    frequencies of the K voiced candidates -> the best path's states
    ``(B, N)`` int64 (K = unvoiced).  Ties go to the lowest state, as
    ``jnp.argmin`` breaks them."""
    b, n, k = emission_voiced.shape
    em = torch.cat([emission_voiced.float(),
                    emission_voiced.new_full((b, n, 1), voiced_bias)], -1)
    lf = torch.cat([log_f0.float(), log_f0.new_zeros((b, n, 1))], -1)
    voiced = (torch.arange(k + 1, device=em.device) < k).float()
    # the transition costs of every frame at once, in JAX's f32 order
    jump = (lf[:, 1:, None, :] - lf[:, :-1, :, None]).abs()
    both = voiced[:, None] * voiced[None, :]
    switch = (voiced[:, None] - voiced[None, :]) ** 2
    trans = transition_octave_cost * jump * both + switch_cost * switch
    cost = em[:, 0]
    back = []
    for t in range(1, n):
        total = cost[:, :, None] + trans[:, t - 1] + em[:, t, None, :]
        cost, arg = torch.min(total, dim=1)
        back.append(arg)
    state = torch.argmin(cost, dim=-1)
    back = torch.stack(back, 1).cpu().numpy() if back else None
    out = np.empty((b, n), np.int64)
    rows = np.arange(b)
    s = state.cpu().numpy()
    for t in range(n - 1, -1, -1):
        out[:, t] = s
        if t > 0:
            s = back[rows, t - 1, s]
    return torch.from_numpy(out).to(em.device)


def viterbi_states(emission_voiced, log_f0, *, voiced_bias: float,
                   transition_octave_cost: float,
                   switch_cost: float) -> torch.Tensor:
    """The best path's states ``(B, N)`` int64 of the trellis over
    ``(B, N, K)`` voiced emissions and log2 frequencies (state K is
    unvoiced), 1 <= K <= 31.  CUDA tensors launch the kernel once for all
    rows; CPU tensors run ``viterbi_states_plain``.  The shapes are
    checked on both, so a CPU run refuses what the kernel would."""
    global launches
    kw = dict(voiced_bias=voiced_bias,
              transition_octave_cost=transition_octave_cost,
              switch_cost=switch_cost)
    _cuda.require(emission_voiced.dim() == 3,
                  f"emissions {tuple(emission_voiced.shape)} are not (B, N, K)")
    b, n, k = emission_voiced.shape
    _cuda.require(tuple(log_f0.shape) == (b, n, k)
                  and log_f0.device == emission_voiced.device,
                  f"log_f0 {tuple(log_f0.shape)} != {(b, n, k)}")
    _cuda.require(1 <= k < MAX_STATES and n >= 1 and b >= 1,
                  f"viterbi_f0 takes 1 <= K <= {MAX_STATES - 1} candidates "
                  f"and N >= 1 frames; got {(b, n, k)}")
    if not emission_voiced.is_cuda:
        return viterbi_states_plain(emission_voiced, log_f0, **kw)
    em = emission_voiced.float().contiguous()
    lf = log_f0.float().contiguous()
    back = torch.empty((b, n, k + 1), dtype=torch.uint8, device=em.device)
    states = torch.empty((b, n), dtype=torch.int64, device=em.device)
    fn = _cuda.library("viterbi_f0").serenade_viterbi_f0
    fn.restype = ctypes.c_int
    err = fn(_cuda.ptr(em), _cuda.ptr(lf), _cuda.ptr(back),
             _cuda.ptr(states), ctypes.c_int(b), ctypes.c_int(n),
             ctypes.c_int(k), ctypes.c_float(voiced_bias),
             ctypes.c_float(transition_octave_cost),
             ctypes.c_float(switch_cost), _cuda.stream())
    _cuda.check(err, "viterbi_f0")
    launches += 1
    return states
