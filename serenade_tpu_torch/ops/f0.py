"""F0 estimation on the device (counterpart of serenade_tpu/ops/f0.py):
YIN's cumulative mean normalized difference (CMND) by FFT
cross-correlation, then either YIN's dip picking (``yin_f0``) or K dip
candidates per frame decoded by a Viterbi trellis (``yin_f0_viterbi``,
pYIN-style).  Every function takes a batch of waveforms ``(B, T)`` (or
one ``(T,)``) and returns ``(f0, vuv)`` of ``(B, n_frames)``: f0 in Hz,
0 where unvoiced.  f32, as the JAX package computes.

The trellis, a ``lax.scan`` over frames and a reverse scan in JAX
(``serenade_tpu/ops/f0.py:301``, ``:314``), is one CUDA kernel launch a
batch on the card (``ops/viterbi_cuda.py``).  Candidates come from a
stable sort, so ties (the many absent candidates at -inf) keep the lowest
lag first, as ``jax.lax.top_k`` orders them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from serenade_tpu_torch import resolve_device
from serenade_tpu_torch.ops import viterbi_cuda

_INF = float("inf")


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _lags(fs: int, f0_floor: float, f0_ceil: float,
          frame_period_ms: float, win_length):
    hop = int(fs * frame_period_ms / 1000.0)
    max_lag = int(np.ceil(fs / f0_floor)) + 1
    min_lag = max(int(np.floor(fs / f0_ceil)), 2)
    return hop, min_lag, max_lag, win_length or _next_pow2(max_lag * 2)


def _cmnd_matrix(audio, fs, f0_floor, f0_ceil, frame_period_ms,
                 win_length):
    """YIN's front half for ``(..., T)`` audio: (cmnd ``(..., N, L)``,
    min_lag, max_lag, energy ``(..., N)``)."""
    hop, min_lag, max_lag, w = _lags(fs, f0_floor, f0_ceil,
                                     frame_period_ms, win_length)
    frame_len = w + max_lag
    n_frames = 1 + audio.shape[-1] // hop
    x = F.pad(audio.float(), (frame_len // 2, frame_len))
    frames = x.unfold(-1, frame_len, hop)[..., :n_frames, :]

    # r(tau) = sum_{t<W} x[t] x[t+tau] by FFT cross-correlation
    nfft = _next_pow2(frame_len + w)
    fa = torch.fft.rfft(frames[..., :w], nfft)
    fb = torch.fft.rfft(frames, nfft)
    corr = torch.fft.irfft(fa.conj() * fb, nfft)[..., :max_lag]

    # p(tau) = sum_{t=tau}^{tau+W-1} x[t]^2 (running energy)
    csum = F.pad(torch.cumsum(frames.square(), dim=-1), (1, 0))
    p_tau = csum[..., w:w + max_lag] - csum[..., :max_lag]
    p_0 = p_tau[..., :1]
    d = p_0 + p_tau - 2.0 * corr
    cum = torch.cumsum(d[..., 1:], dim=-1)
    tau_idx = torch.arange(1, max_lag, dtype=torch.float32,
                           device=audio.device)
    cmnd = torch.cat([torch.ones_like(p_0),
                      d[..., 1:] * tau_idx / torch.clamp_min(cum, 1e-12)],
                     dim=-1)
    return cmnd, min_lag, max_lag, p_0[..., 0] / w


def _take(a, idx):
    return torch.gather(a, -1, idx[..., None])[..., 0]


def yin_f0(audio, fs: int = 24000, f0_floor: float = 60.0,
           f0_ceil: float = 1100.0, frame_period_ms: float = 10.0,
           win_length: int | None = None, threshold: float = 0.12
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """YIN: the first dip under ``threshold`` (else the band's minimum),
    walked down to its local minimum, refined by a parabola; voiced where
    the dip is convincing and the frame has energy."""
    cmnd, min_lag, max_lag, energy = _cmnd_matrix(
        audio, fs, f0_floor, f0_ceil, frame_period_ms, win_length)
    taus = torch.arange(max_lag, device=cmnd.device)
    lag_mask = (taus >= min_lag) & (taus < max_lag - 1)
    band = torch.where(lag_mask, cmnd, _INF)

    below = band < threshold
    first_below = torch.argmax(below.to(torch.uint8), dim=-1)
    raw_tau = torch.where(below.any(dim=-1), first_below,
                          torch.argmin(band, dim=-1))
    # the local-minimum walk (a while_loop in JAX): the first t >= raw_tau
    # at which the row stops descending
    descending = torch.zeros_like(below)
    descending[..., :max_lag - 2] = band[..., 1:max_lag - 1] < band[
        ..., :max_lag - 2]
    stop = ~descending & (taus >= raw_tau[..., None])
    raw_tau = torch.argmax(stop.to(torch.uint8), dim=-1)

    t0 = torch.clamp(raw_tau, min_lag, max_lag - 2)
    ym1, y0, yp1 = _take(cmnd, t0 - 1), _take(cmnd, t0), _take(cmnd, t0 + 1)
    denom = ym1 - 2.0 * y0 + yp1
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (ym1 - yp1) / denom, 0.0)
    tau_star = t0.float() + torch.clamp(delta, -1.0, 1.0)
    f0 = fs / torch.clamp_min(tau_star, 1.0)
    vuv = ((y0 < max(threshold * 2.5, 0.35)) & (energy > 1e-7)
           & (f0 >= f0_floor) & (f0 <= f0_ceil)).float()
    return torch.where(vuv > 0, f0, 0.0), vuv


def yin_f0_viterbi(audio, fs: int = 24000, f0_floor: float = 60.0,
                   f0_ceil: float = 1100.0, frame_period_ms: float = 10.0,
                   win_length: int | None = None, n_candidates: int = 5,
                   voiced_bias: float = 0.35,
                   transition_octave_cost: float = 6.0,
                   switch_cost: float = 0.4,
                   lag_octave_penalty: float = 0.02):
    """YIN + Viterbi continuity decoding: per frame the K best CMND dips
    (parabola-interpolated depth plus a per-octave lag penalty) become
    voiced candidates beside one unvoiced state; the path minimizes dip
    depth + octave jumps + voicing switches."""
    cmnd, min_lag, max_lag, energy = _cmnd_matrix(
        audio, fs, f0_floor, f0_ceil, frame_period_ms, win_length)
    taus = torch.arange(cmnd.shape[-1], device=cmnd.device)
    band = (taus >= min_lag) & (taus < max_lag - 1)
    c_band = torch.where(band, cmnd, _INF)

    ym1 = F.pad(cmnd[..., :-1], (1, 0), value=_INF)
    yp1 = F.pad(cmnd[..., 1:], (0, 1), value=_INF)
    y0 = cmnd
    denom_all = ym1 - 2.0 * y0 + yp1
    safe_denom = torch.where(denom_all.abs() > 1e-12, denom_all, 1.0)
    delta_all = torch.clamp(0.5 * (ym1 - yp1) / safe_denom, -1.0, 1.0)
    interp_all = torch.clamp_min(
        y0 - 0.125 * (ym1 - yp1).square() / safe_denom, 0.0)
    is_min = ((c_band <= torch.where(torch.isinf(ym1), _INF, ym1))
              & (c_band < torch.where(torch.isinf(yp1), _INF, yp1)))
    lag_pen = lag_octave_penalty * torch.log2(
        torch.clamp_min(taus.float(), 1.0) / float(min_lag))
    score = torch.where(is_min & band, interp_all + lag_pen, _INF)
    neg_vals, cand_tau = torch.sort(-score, dim=-1, descending=True,
                                    stable=True)
    cand_cost = -neg_vals[..., :n_candidates]
    t0 = torch.clamp(cand_tau[..., :n_candidates], min_lag, max_lag - 2)
    tau_star = t0.float() + torch.gather(delta_all, -1, t0)
    cand_f0 = fs / torch.clamp_min(tau_star, 1.0)
    valid = torch.isfinite(cand_cost) & (energy[..., None] > 1e-7)
    emission_voiced = torch.where(valid, cand_cost, 1e6)
    return viterbi_f0_select(
        cand_f0, emission_voiced, voiced_bias=voiced_bias,
        transition_octave_cost=transition_octave_cost,
        switch_cost=switch_cost, f0_floor=f0_floor, f0_ceil=f0_ceil)


def viterbi_f0_select(cand_f0, emission_voiced, *, voiced_bias: float,
                      transition_octave_cost: float, switch_cost: float,
                      f0_floor: float, f0_ceil: float):
    """The (K+1)-state voiced/unvoiced trellis over ``(..., N, K)``
    candidate frequencies and their emission costs (about 1e6 for absent
    ones): K voiced states plus one unvoiced state at cost
    ``voiced_bias``; the path minimizes emission + octave-jump +
    voicing-switch costs.  Returns (f0, vuv) ``(..., N)``, f0 0 where
    unvoiced or outside [f0_floor, f0_ceil]."""
    log_f0 = torch.log2(torch.clamp_min(cand_f0, 1.0))
    lead = cand_f0.shape[:-2]
    states = viterbi_cuda.viterbi_states(
        emission_voiced.reshape(-1, *emission_voiced.shape[-2:]),
        log_f0.reshape(-1, *log_f0.shape[-2:]), voiced_bias=voiced_bias,
        transition_octave_cost=transition_octave_cost,
        switch_cost=switch_cost).reshape(*lead, -1)
    return f0_of_states(cand_f0, states, f0_floor, f0_ceil)


def f0_of_states(cand_f0, states, f0_floor: float, f0_ceil: float):
    """(f0, vuv) of a trellis path: each frame's candidate frequency at
    its state, 0 at the unvoiced state (K) and outside [f0_floor,
    f0_ceil]."""
    f0 = _take(F.pad(cand_f0, (0, 1)), states)
    keep = ((states < cand_f0.shape[-1]) & (f0 >= f0_floor)
            & (f0 <= f0_ceil))
    f0 = torch.where(keep, f0, 0.0)
    return f0, (f0 > 0).float()


def smooth_f0_median(f0, width: int = 5):
    """Median over a ``width`` window (edge-padded) at voiced frames; 0s
    stay 0.  ``(..., N)``."""
    pad = width // 2
    shape = f0.shape
    padded = F.pad(f0.reshape(-1, 1, shape[-1]), (pad, pad),
                   mode="replicate").reshape(*shape[:-1], -1)
    med = padded.unfold(-1, width, 1).median(dim=-1).values
    return torch.where(f0 > 0, med, 0.0)


def world_extract_compatible(audio, fs: int, f0min: float, f0max: float,
                             frame_period_ms: float = 10.0, *, device=None
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """The F0 path of the reference's ``world_extract`` in one call: YIN,
    then the median smoothing, then ``vuv = f0 > 0``.  ``audio`` is a host
    or device waveform ``(T,)`` (or ``(B, T)``); it runs on ``device``
    (the card unless the caller names another) and returns host arrays
    ``(f0, vuv)``, f32."""
    dev = resolve_device(device)
    x = torch.as_tensor(audio, dtype=torch.float32).to(dev)
    f0, _ = yin_f0(x, fs=fs, f0_floor=float(f0min), f0_ceil=float(f0max),
                   frame_period_ms=frame_period_ms)
    f0 = smooth_f0_median(f0)
    return f0.cpu().numpy(), (f0 > 0).float().cpu().numpy()
