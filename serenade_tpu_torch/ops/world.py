"""WORLD's CheapTrick spectral envelope on the device (counterpart of
serenade_tpu/ops/world.py:48-181).

Every frame evaluates at once, batched over rows as JAX's vmapped program
is: the pitch-adaptive window (3·T0 Hanning) becomes a masked window in a
fixed ``fft_size`` buffer; the FFTs, the DC correction, the rectangular
smoothing of width 2·f0/3 and the cepstral liftering
``sin(π f0 q)/(π f0 q) · ((1 - 2 q1) + 2 q1 cos(2π f0 q))``, q1 = -0.15,
are batched tensor ops.  Unvoiced frames take WORLD's default F0 (500 Hz).

f32 as in the JAX package, but for the smoothing's running sums: the
box filter's areas are differences of a cumulative sum over up to 1,025
bins, whose f32 rounding (about 6e-5 of a frame's mean power) swamps the
quiet bins; the port sums in f64.  Band aperiodicity and D4C
(``world.py:182-429``) are not ported (ROADMAP Queue A, items 6-7).
"""

from __future__ import annotations

import math

import torch

DEFAULT_F0 = 500.0
Q1 = -0.15


def _fft_size_for(fs: int, f0_floor: float) -> int:
    return 1 << math.ceil(math.log2(3.0 * fs / f0_floor + 1.0))


def _dc_correct(power, f0_safe, bin_hz: float):
    """WORLD DCCorrection of ``(..., T, F)`` power: bins below f0 have no
    harmonic support, so the spectrum mirrored around f0 is added there
    (P(f) += P(f0 - f) for f < f0)."""
    n_bins = power.shape[-1]
    k = torch.arange(n_bins, dtype=torch.float32, device=power.device)
    f0_bins = f0_safe[..., None] / bin_hz
    mirror = f0_bins - k
    lo = torch.clamp(torch.floor(mirror), 0.0, n_bins - 2.0)
    frac = torch.clamp(mirror - lo, 0.0, 1.0)
    lo_i = lo.long()
    p_lo = torch.gather(power, -1, lo_i)
    p_hi = torch.gather(power, -1, lo_i + 1)
    replica = (1.0 - frac) * p_lo + frac * p_hi
    return torch.where(k < f0_bins, power + replica, power)


def _linear_smooth(spec, width_bins):
    """WORLD LinearSmoothing of ``(..., T, F)``: a box filter of
    fractional width ``width_bins`` ``(..., T)`` per row, integrated from
    a running sum (in f64) with linear interpolation at the edges."""
    n_bins = spec.shape[-1]
    spec64 = spec.double()
    csum = torch.nn.functional.pad(torch.cumsum(spec64, dim=-1), (1, 0))
    k = torch.arange(n_bins, dtype=torch.float32, device=spec.device)
    w = width_bins[..., None]
    lo = torch.clamp(k - w / 2.0, 0.0, n_bins - 1.0)
    hi = torch.clamp(k + w / 2.0, 0.0, n_bins - 1.0)
    lo_i = torch.floor(lo).long()
    hi_i = torch.floor(hi).long()
    area = (torch.gather(csum, -1, hi_i) - torch.gather(csum, -1, lo_i)
            + (hi - hi_i).double() * torch.gather(
                spec64, -1, torch.clamp(hi_i, max=n_bins - 1))
            - (lo - lo_i).double() * torch.gather(
                spec64, -1, torch.clamp(lo_i, max=n_bins - 1)))
    return (area / torch.clamp(hi - lo, min=1e-6).double()).float()


def cheaptrick(x: torch.Tensor, f0: torch.Tensor, fs: int = 24000,
               f0_floor: float = 71.0, frame_period_ms: float = 5.0,
               elim_0th: bool = False) -> torch.Tensor:
    """Spectral envelope |H(w)|², ``(..., T, fft_size // 2 + 1)`` with
    ``fft_size`` the power of two above 3·fs/f0_floor.

    Args:
        x: ``(..., N)`` waveforms.
        f0: ``(..., T)`` per-frame F0 in Hz (0 = unvoiced), frames ``hop``
            apart from sample 0.
        elim_0th: zero the 0th cepstral coefficient before rebuilding the
            envelope (its overall gain; the SiFiGAN residual-loss
            convention).
    """
    fft_size = _fft_size_for(fs, f0_floor)
    hop = int(fs * frame_period_ms / 1000.0)
    n_frames = f0.shape[-1]
    f0 = f0.float()
    f0_safe = torch.where(f0 <= 0, DEFAULT_F0, f0)
    f0_safe = torch.clamp(f0_safe, min=f0_floor)

    # a fixed window of samples around each frame centre t·hop:
    # [t·hop - fft_size/2, t·hop + fft_size/2)
    max_half = fft_size // 2
    pad = max_half + 1
    xp = torch.nn.functional.pad(x.float(), (pad, pad))
    frames = xp[..., 1:].unfold(-1, fft_size, hop)
    if frames.shape[-2] < n_frames:
        raise ValueError(f"{n_frames} F0 frames at hop {hop} exceed the "
                         f"waveform's {x.shape[-1]} samples")
    frames = frames[..., :n_frames, :]

    # pitch-synchronous Hanning of length 3·T0, masked inside the buffer
    offs = torch.arange(-max_half, max_half, device=x.device)
    half_len = torch.round(1.5 * fs / f0_safe).to(torch.int32)[..., None]
    in_win = (offs.abs() <= half_len).float()
    win = 0.5 + 0.5 * torch.cos(
        math.pi * offs / torch.clamp(half_len, min=1))
    win = win * in_win

    # DC removal: the window-weighted mean (WORLD GetWindowedWaveform)
    wsum = win.sum(dim=-1, keepdim=True)
    mean = (frames * win).sum(dim=-1, keepdim=True) / torch.clamp(
        wsum, min=1e-9)
    windowed = (frames - mean) * win
    power = torch.fft.rfft(windowed, fft_size).abs().square()

    # per-frame gain normalization: the DC correction and the smoothing
    # are linear in power, so dividing by the frame mean here and adding
    # log(mean) back after the log is exact, and keeps the envelope
    # gain-equivariant
    frame_gain = torch.clamp(power.mean(dim=-1, keepdim=True), min=1e-30)
    power = power / frame_gain + 1e-12

    bin_hz = fs / fft_size
    power = _dc_correct(power, f0_safe, bin_hz)
    smoothed = _linear_smooth(power, (2.0 * f0_safe / 3.0) / bin_hz)

    # cepstral liftering: log spectrum -> quefrency -> lifter -> back
    log_s = torch.log(torch.clamp(smoothed, min=1e-12)) + torch.log(
        frame_gain)
    ceps = torch.fft.irfft(log_s, n=fft_size, dim=-1)
    if elim_0th:
        ceps = torch.cat([torch.zeros_like(ceps[..., :1]), ceps[..., 1:]],
                         dim=-1)
    q_idx = torch.arange(fft_size, device=x.device)
    q = torch.minimum(q_idx, fft_size - q_idx).float() / fs
    f0q = f0_safe[..., None] * q
    lifter = torch.where(
        f0q == 0, 1.0,
        torch.sin(math.pi * f0q) / torch.clamp(math.pi * f0q, min=1e-9))
    comp = (1.0 - 2.0 * Q1) + 2.0 * Q1 * torch.cos(2.0 * math.pi * f0q)
    log_env = torch.fft.rfft(ceps * lifter * comp, dim=-1).real
    return torch.exp(log_env)
