"""Harvest-class F0 estimation on the device (counterpart of
serenade_tpu/ops/harvest.py).

Harvest (Morise, INTERSPEECH 2017) finds F0 candidates by band-passing
the signal at log-spaced centre frequencies and reading the period off
four event-interval detectors (falling and rising zero crossings, peaks,
dips), then refines each candidate by its harmonics' instantaneous
frequency.  As in the JAX package, every stage is a fixed-shape batched
tensor program over rows ``(B, N)``:

* the signal is decimated to 8 kHz by rFFT bin truncation, and all C
  channels band-pass in one batched spectral product (the filter bank is
  built in numpy f64 once per (length, fs, floor, ceil) and kept on the
  device, as JAX's static arguments keep the program);
* event intervals per sample come from ``torch.cummax``/``cummin``
  forward and backward fills (JAX's ``lax.cummax``/``cummin``);
* runs of consecutive channels with valid candidates merge into K slots
  (mean over the run) with segment sums over the channel axis: JAX's
  ``lax.scan`` over the ~100 channels becomes one cumulative sum and two
  scatter-adds, the sums in f64 (JAX's running f32 sum rounds once a
  channel);
* refinement evaluates windowed DFTs at the six harmonics of every
  candidate (Flanagan's instantaneous frequency from a derivative
  window), vectorized over frames and slots in bounded chunks;
* the track is the (K+1)-state V/UV trellis of ``ops/f0.py``, one launch
  of the Viterbi kernel (``csrc/viterbi_f0.cu``) for the batch.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from serenade_tpu_torch.ops.f0 import viterbi_f0_select
from serenade_tpu_torch.ops.world import _nuttall

_TARGET_FS = 8000.0   # candidate and refinement rate, as WORLD's Harvest
# (frames x slots x window) elements a refinement chunk holds at once
_REFINE_CHUNK = 1 << 24


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=16)
def _plan(length: int, fs: int, f0_floor: float, f0_ceil: float,
          device: str) -> dict:
    """Decimation, FFT sizes and the band-pass filter bank, built in numpy
    f64 as in JAX and kept on ``device`` once per key: Nuttall envelopes
    of two periods each side, modulated to channels 1/24 octave apart
    over [floor 2^(1/24), ceil], centred at t = 0 in the decimated
    signal's FFT."""
    r = max(int(fs // _TARGET_FS), 1)
    fs_d = fs / r
    len_d = (length + r - 1) // r
    n_ch = int(np.ceil(np.log2(f0_ceil / f0_floor) * 24.0))
    boundary_f0 = f0_floor * 2.0 ** ((np.arange(n_ch) + 1) / 24.0)
    max_flh = int(round(fs_d / boundary_f0[0] * 2.0))
    nfft_d = _next_pow2(len_d + 4 * max_flh)
    k = np.arange(-max_flh, max_flh + 1)
    filters = np.zeros((n_ch, nfft_d), np.float64)
    for i, bf0 in enumerate(boundary_f0):
        flh = int(round(fs_d / bf0 * 2.0))
        win = _nuttall(2 * flh + 1) * np.cos(
            2.0 * np.pi * bf0 * k[max_flh - flh:max_flh + flh + 1] / fs_d)
        filters[i, np.arange(-flh, flh + 1) % nfft_d] = win
    h_spec = np.fft.rfft(filters, nfft_d).astype(np.complex64)
    return dict(r=r, fs_d=fs_d, len_d=len_d, nfft_d=nfft_d,
                nfft_full=nfft_d * r,
                boundary_f0=torch.from_numpy(
                    boundary_f0.astype(np.float32)).to(device),
                h_spec=torch.from_numpy(h_spec).to(device))


def _interval_f0(sig, valid_len: int, frame_samples, fs_d: float):
    """F0 per frame from the falling zero crossings of ``sig`` ``(..., n)``:
    fs_d over the sub-sample interval between the events enclosing each
    frame sample, from forward and backward fills of the events' integer
    cells (their fractions gathered per event, so the interval keeps full
    sub-sample precision at any position).  Returns ``(..., F)``, 0 where
    no interval encloses the frame."""
    n = sig.shape[-1]
    a, b = sig[..., :-1], sig[..., 1:]
    t = torch.arange(n - 1, device=sig.device)
    ev = (a > 0) & (b <= 0) & (a != b) & (t < valid_len - 1)
    frac = a / torch.where(a == b, 1.0, a - b)
    prev_cell = torch.cummax(torch.where(ev, t, -1), dim=-1).values
    next_cell = torch.flip(torch.cummin(torch.flip(
        torch.where(ev, t, n), [-1]), dim=-1).values, [-1])
    s = torch.clamp(frame_samples, 0, n - 2)
    pv = prev_cell[..., s]
    # the backward fill read one cell later: an event inside cell s is the
    # previous event, and next_cell[s] would return it again
    nx = next_cell[..., torch.clamp(s + 1, max=n - 2)]
    good = (pv >= 0) & (nx < n)
    frac_pv = torch.gather(frac, -1, torch.clamp(pv, 0, n - 2))
    frac_nx = torch.gather(frac, -1, torch.clamp(nx, 0, n - 2))
    interval = (nx - pv).float() + (frac_nx - frac_pv)
    good = good & (interval > 1e-3)
    return torch.where(good, fs_d / torch.clamp(interval, min=1e-3), 0.0)


def _merge_channel_runs(cand, n_slots: int):
    """Runs of consecutive channels with valid candidates ``(..., C, F)``
    (0 invalid) -> their means in the first ``n_slots`` slots per frame,
    in channel order, ``(..., F, K)`` (0 in unused slots).  A run's slot
    is the count of runs that started before it; its sum and length are
    scatter-added into it, the sum in f64."""
    valid = cand > 0.0
    before = torch.cat([torch.zeros_like(valid[..., :1, :]),
                        valid[..., :-1, :]], dim=-2)
    starts = valid & ~before
    slot = torch.cumsum(starts.long(), dim=-2) - 1
    slot = torch.where(valid & (slot < n_slots), slot, n_slots)
    shape = (*cand.shape[:-2], cand.shape[-1], n_slots + 1)
    idx = slot.transpose(-1, -2)
    sums = torch.zeros(shape, dtype=torch.float64, device=cand.device)
    sums.scatter_add_(-1, idx, cand.transpose(-1, -2).double())
    lens = torch.zeros(shape, dtype=torch.float64, device=cand.device)
    lens.scatter_add_(-1, idx, valid.transpose(-1, -2).double())
    means = (sums / torch.clamp(lens, min=1.0)).float()
    return means[..., :n_slots]


def _refine_chunk(xseg, c, t_rel, fs_d: float, n_harmonics: int):
    """(num, den, dev) ``(..., K)`` of candidates ``c`` ``(..., K)`` over
    frames ``xseg`` ``(..., W)``: a Nuttall window over three periods of
    each candidate and its time derivative, and at each harmonic h the
    windowed DFT's instantaneous frequency, which votes (weighted by its
    amplitude) where it lands within 10 % of the candidate."""
    two_pi = 2.0 * math.pi
    nyq = 0.5 * fs_d
    ck = c[..., None]                                   # (..., K, 1)
    u = t_rel * ck / 3.0 + 0.5                          # (..., K, W)
    in_win = (u >= 0.0) & (u <= 1.0)
    w = (0.355768 - 0.487396 * torch.cos(two_pi * u)
         + 0.144232 * torch.cos(2 * two_pi * u)
         - 0.012604 * torch.cos(3 * two_pi * u))
    dw = (0.487396 * two_pi * torch.sin(two_pi * u)
          - 0.144232 * 2 * two_pi * torch.sin(2 * two_pi * u)
          + 0.012604 * 3 * two_pi * torch.sin(3 * two_pi * u)) * (ck / 3.0)
    xs = xseg[..., None, :]
    xw = xs * torch.where(in_win, w, 0.0)
    xdw = xs * torch.where(in_win, dw, 0.0)
    num = torch.zeros_like(c)
    den = torch.zeros_like(c)
    dev = torch.zeros_like(c)
    for h in range(1, n_harmonics + 1):
        fh = c * h
        ph = two_pi * fh[..., None] * t_rel
        cs, sn = torch.cos(ph), torch.sin(ph)
        re = (xw * cs).sum(-1)
        im = -(xw * sn).sum(-1)
        re_d = (xdw * cs).sum(-1)
        im_d = -(xdw * sn).sum(-1)
        p = re * re + im * im
        delta = -(im_d * re - re_d * im) / (two_pi * torch.clamp(p, min=1e-20))
        amp = torch.sqrt(torch.clamp(p, min=0.0))
        est = (fh + delta) / h
        ok = ((fh < nyq) & ((est - c).abs() < 0.1 * c)).float()
        num = num + ok * amp * est
        den = den + ok * amp
        dev = dev + ok * amp * (est - c).abs()
    return num, den, dev


def _refine_candidates(x_d, valid_len: int, frame_samples, cand, fs_d: float,
                       f0_floor: float, f0_ceil: float,
                       n_harmonics: int = 6):
    """Instantaneous-frequency refinement of ``(B, F, K)`` candidates:
    the amplitude-weighted mean of each harmonic's IF over its number,
    and as cost the weighted relative IF spread.  Returns (refined f0,
    cost), each ``(B, F, K)``, cost 1e6 where a candidate is rejected."""
    w_max = int(np.ceil(3.0 * fs_d / f0_floor)) + 1
    half = w_max // 2
    dev_ = x_d.device
    t_rel = (torch.arange(w_max, dtype=torch.float32, device=dev_)
             - half) / fs_d
    pad = half + 1
    xp = F.pad(x_d[..., :valid_len], (pad, pad))
    seg_idx = torch.clamp(frame_samples[:, None] + torch.arange(
        w_max, device=dev_) + (pad - half), 0, xp.shape[-1] - 1)
    xseg = xp[..., seg_idx]                                  # (B, F, W)
    c = torch.clamp(cand, min=1.0)
    b, n_frames, k = cand.shape
    step = max(1, _REFINE_CHUNK // max(1, b * k * w_max))
    parts = [_refine_chunk(xseg[:, i:i + step], c[:, i:i + step], t_rel,
                           fs_d, n_harmonics)
             for i in range(0, n_frames, step)]
    num, den, dev = (torch.cat(p, dim=1) for p in zip(*parts))
    refined = num / torch.clamp(den, min=1e-12)
    spread = dev / torch.clamp(den * torch.clamp(refined, min=1.0),
                               min=1e-12)
    good = ((cand > 0.0) & (den > 1e-8) & ((refined - c).abs() < 0.18 * c)
            & (refined >= f0_floor) & (refined <= f0_ceil))
    return (torch.where(good, refined, 0.0),
            torch.where(good, spread, 1e6))


def harvest_f0(audio: torch.Tensor, fs: int = 24000, f0_floor: float = 60.0,
               f0_ceil: float = 1100.0, frame_period_ms: float = 10.0,
               n_candidates: int = 16, voiced_bias: float = 0.12,
               transition_octave_cost: float = 6.0,
               switch_cost: float = 0.4, cost_scale: float = 4.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Harvest-class ``(f0, vuv)`` of ``(..., N)`` waveforms at
    ``frame_period_ms``: f0 in Hz, 0 where unvoiced, ``1 + N // hop``
    frames.  Rows of one length run as one batch (JAX vmaps them); zero
    padding at a row's end stays unvoiced."""
    lead = audio.shape[:-1]
    x = audio.float().reshape(-1, audio.shape[-1])
    length = x.shape[-1]
    dev = x.device
    plan = _plan(length, fs, float(f0_floor), float(f0_ceil), str(dev))
    r, fs_d, len_d = plan["r"], plan["fs_d"], plan["len_d"]
    nfft_d, nfft_full = plan["nfft_d"], plan["nfft_full"]
    hop = int(fs * frame_period_ms / 1000.0)
    n_frames = 1 + length // hop
    frame_samples = torch.clamp(
        (torch.arange(n_frames, dtype=torch.float32, device=dev)
         * (hop / r)).long(), max=len_d - 1)

    # ideal low-pass decimation by rFFT bin truncation
    spec_d = torch.fft.rfft(x, nfft_full)[..., :nfft_d // 2 + 1] / r
    spec_d = torch.cat([spec_d[..., :-1], spec_d[..., -1:].real.to(
        spec_d.dtype)], dim=-1)
    x_d = torch.fft.irfft(spec_d, nfft_d)[..., :len_d]

    # every channel in one batched spectral product: (B, C, nfft_d)
    y = torch.fft.irfft(torch.fft.rfft(x_d, nfft_d)[:, None, :]
                        * plan["h_spec"], nfft_d)
    dy = y[..., 1:] - y[..., :-1]
    est = torch.stack([
        _interval_f0(y, len_d, frame_samples, fs_d),        # falling ZC
        _interval_f0(-y, len_d, frame_samples, fs_d),       # rising ZC
        _interval_f0(dy, len_d - 1, frame_samples, fs_d),   # peaks
        _interval_f0(-dy, len_d - 1, frame_samples, fs_d),  # dips
    ])                                                      # (4, B, C, F)
    mean4 = est.mean(dim=0)
    bf0 = plan["boundary_f0"][:, None]
    in_gate = ((est > 0.0).all(dim=0) & (mean4 > 0.9 * bf0)
               & (mean4 < 1.1 * bf0) & (mean4 >= f0_floor)
               & (mean4 <= f0_ceil))
    cand = _merge_channel_runs(torch.where(in_gate, mean4, 0.0),
                               n_candidates)                 # (B, F, K)
    refined, cost = _refine_candidates(x_d, len_d, frame_samples, cand,
                                       fs_d, f0_floor, f0_ceil)
    f0, vuv = viterbi_f0_select(
        refined, cost * cost_scale, voiced_bias=voiced_bias,
        transition_octave_cost=transition_octave_cost,
        switch_cost=switch_cost, f0_floor=f0_floor, f0_ceil=f0_ceil)
    return f0.reshape(*lead, n_frames), vuv.reshape(*lead, n_frames)
