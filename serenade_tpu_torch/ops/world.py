"""WORLD-class spectral analysis on the device (counterpart of
serenade_tpu/ops/world.py): the CheapTrick envelope, band aperiodicity
and D4C.

Every frame evaluates at once, batched over rows as JAX's vmapped program
is: the pitch-adaptive window (3·T0 Hanning) becomes a masked window in a
fixed ``fft_size`` buffer; the FFTs, the DC correction, the rectangular
smoothing of width 2·f0/3 and the cepstral liftering
``sin(π f0 q)/(π f0 q) · ((1 - 2 q1) + 2 q1 cos(2π f0 q))``, q1 = -0.15,
are batched tensor ops.  Unvoiced frames take WORLD's default F0 (500 Hz).

f32 as in the JAX package, but for the smoothing's running sums: the
box filter's areas are differences of a cumulative sum over up to 1,025
bins, whose f32 rounding (about 6e-5 of a frame's mean power) swamps the
quiet bins; the port sums in f64.

Two aperiodicity estimators feed SiFiGAN's ``bap`` conditioning (3 bands
of 3 kHz at 24 kHz, WORLD's coded layout): ``band_aperiodicity``, the
band's normalized autocorrelation at the pitch period against the
window's own (Wiener-Khinchin with the exact fractional lag), and
``d4c``, WORLD's static-group-delay measure with its LoveTrain voicing
gate.  Both are batched rFFTs over frames; their band and cumulative sums
run in f64 as the smoothing does.  ``aperiodicity_spectrum`` expands the
coded bands to a full linear spectrum on the host.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

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


def _linear_smooth(spec, width_bins, dtype=torch.float32):
    """WORLD LinearSmoothing of ``(..., T, F)``: a box filter of
    fractional width ``width_bins`` ``(..., T)`` per row, integrated from
    a running sum (in f64) with linear interpolation at the edges; the
    result in ``dtype``."""
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
    return (area / torch.clamp(hi - lo, min=1e-6).double()).to(dtype)


def cheaptrick(x: torch.Tensor, f0: torch.Tensor, fs: int = 24000,
               f0_floor: float = 71.0, frame_period_ms: float = 5.0,
               elim_0th: bool = False,
               fft_size: Optional[int] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Spectral envelope |H(w)|², ``(..., T, fft_size // 2 + 1)``;
    ``fft_size`` by default the power of two above 3·fs/f0_floor.
    Computed in ``dtype`` (f64 where a caller asks, as an f64 training
    step's residual loss does), the smoothing's sums in f64 either way.

    Args:
        x: ``(..., N)`` waveforms.
        f0: ``(..., T)`` per-frame F0 in Hz (0 = unvoiced), frames ``hop``
            apart from sample 0.
        elim_0th: zero the 0th cepstral coefficient before rebuilding the
            envelope (its overall gain; the SiFiGAN residual-loss
            convention).
    """
    if fft_size is None:
        fft_size = _fft_size_for(fs, f0_floor)
    hop = int(fs * frame_period_ms / 1000.0)
    n_frames = f0.shape[-1]
    f0 = f0.to(dtype)
    f0_safe = torch.where(f0 <= 0, DEFAULT_F0, f0)
    f0_safe = torch.clamp(f0_safe, min=f0_floor)

    # a fixed window of samples around each frame centre t·hop:
    # [t·hop - fft_size/2, t·hop + fft_size/2)
    max_half = fft_size // 2
    pad = max_half + 1
    xp = torch.nn.functional.pad(x.to(dtype), (pad, pad))
    frames = xp[..., 1:].unfold(-1, fft_size, hop)
    if frames.shape[-2] < n_frames:
        raise ValueError(f"{n_frames} F0 frames at hop {hop} exceed the "
                         f"waveform's {x.shape[-1]} samples")
    frames = frames[..., :n_frames, :]

    # pitch-synchronous Hanning of length 3·T0, masked inside the buffer
    offs = torch.arange(-max_half, max_half, device=x.device).to(dtype)
    half_len = torch.round(1.5 * fs / f0_safe).to(torch.int32)[..., None]
    in_win = (offs.abs() <= half_len).to(dtype)
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
    smoothed = _linear_smooth(power, (2.0 * f0_safe / 3.0) / bin_hz, dtype)

    # cepstral liftering: log spectrum -> quefrency -> lifter -> back
    log_s = torch.log(torch.clamp(smoothed, min=1e-12)) + torch.log(
        frame_gain)
    ceps = torch.fft.irfft(log_s, n=fft_size, dim=-1)
    if elim_0th:
        ceps = torch.cat([torch.zeros_like(ceps[..., :1]), ceps[..., 1:]],
                         dim=-1)
    q_idx = torch.arange(fft_size, device=x.device)
    q = torch.minimum(q_idx, fft_size - q_idx).to(dtype) / fs
    f0q = f0_safe[..., None] * q
    lifter = torch.where(
        f0q == 0, 1.0,
        torch.sin(math.pi * f0q) / torch.clamp(math.pi * f0q, min=1e-9))
    comp = (1.0 - 2.0 * Q1) + 2.0 * Q1 * torch.cos(2.0 * math.pi * f0q)
    log_env = torch.fft.rfft(ceps * lifter * comp, dim=-1).real
    return torch.exp(log_env)


def _frames_at(x, origins, half: int, pad: int):
    """``(B, T, 2 half)`` windows of ``x`` ``(B, N)`` zero-padded by
    ``pad`` on both sides, starting ``half`` samples before each integer
    origin of ``origins`` ``(B, T)``; the caller keeps every window inside
    the padded signal."""
    view = F.pad(x.float(), (pad, pad)).unfold(-1, 2 * half, 1)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return view[rows, origins.long() + (pad - half)]


def _as_batch(x, f0):
    """(x ``(B, N)``, f0 ``(B, T)``, the leading shape to restore)."""
    lead = f0.shape[:-1]
    return (x.reshape(-1, x.shape[-1]), f0.float().reshape(-1, f0.shape[-1]),
            lead)


def band_edges(fs: int) -> np.ndarray:
    """Coarse aperiodicity centre frequencies, 3 kHz apart and capped as
    WORLD's CodeAperiodicity caps them: floor(min(15000, fs/2 - 3000) /
    3000) bands (3 at 24 kHz, SiFiGAN's bap width)."""
    n_bands = int(min(15000.0, fs / 2.0 - 3000.0) // 3000.0)
    return np.arange(1, n_bands + 1) * 3000.0


def band_aperiodicity(x: torch.Tensor, f0: torch.Tensor, fs: int = 24000,
                      frame_period_ms: float = 5.0) -> torch.Tensor:
    """Coarse band aperiodicity in dB, ``(..., T, n_bands)``: per band,
    1 - r(T0) / r_w(T0) of a 1,024-sample Hann frame, r the band's
    normalized autocorrelation at the pitch period and r_w the window's
    own (both as sums over the half spectrum, DC and Nyquist half
    weighted), clipped to [1e-6, 1]; unvoiced frames 0 dB.  ``x``
    ``(..., N)``, ``f0`` ``(..., T)`` in Hz (0 unvoiced)."""
    x, f0, lead = _as_batch(x, f0)
    hop = int(fs * frame_period_ms / 1000.0)
    n_frames = f0.shape[-1]
    f0_safe = torch.clamp(torch.where(f0 <= 0, DEFAULT_F0, f0), min=40.0)
    win_len, nfft = 1024, 2048   # zero-padded: a linear autocorrelation
    frames = F.pad(x.float(), (win_len // 2, win_len)).unfold(
        -1, win_len, hop)
    if frames.shape[-2] < n_frames:
        raise ValueError(f"{n_frames} F0 frames at hop {hop} exceed the "
                         f"waveform's {x.shape[-1]} samples")
    frames = frames[..., :n_frames, :]
    dev = x.device
    window = 0.5 - 0.5 * torch.cos(
        2.0 * math.pi * torch.arange(win_len, device=dev) / win_len)
    freqs = torch.fft.rfftfreq(nfft, 1.0 / fs, device=dev)
    wgt = torch.ones_like(freqs)
    wgt[0] = wgt[-1] = 0.5
    power = torch.fft.rfft(frames * window, nfft).abs().square() * wgt

    # Wiener-Khinchin: r(tau) = sum_f P(f) cos(2 pi f tau), the exact
    # fractional period in the phase
    tau = 1.0 / f0_safe
    cosm = torch.cos(2.0 * math.pi * freqs * tau[..., None]).double()
    w2 = (torch.fft.rfft(window, nfft).abs().square() * wgt).double()
    r_w = (w2 * cosm).sum(-1) / w2.sum()

    # the ratios in f64 too: 1 - r is down to 1e-6 at the most periodic
    # frames, where one f32 step of r is worth more than 1e-2 dB
    edges = band_edges(fs)
    power = power.double()
    cols = []
    for lo, hi in zip(np.concatenate([[0.0], edges[:-1]]), edges):
        p = power * ((freqs >= lo) & (freqs < hi))
        energy = p.sum(-1)
        r = (p * cosm).sum(-1)
        rn = r / torch.clamp(energy, min=1e-12) / torch.clamp(r_w, min=1e-3)
        cols.append(10.0 * torch.log10(torch.clamp(1.0 - rn, 1e-6, 1.0)))
    bap = torch.stack(cols, dim=-1).float()
    bap = torch.where((f0 <= 0)[..., None], 0.0, bap)
    return bap.reshape(*lead, n_frames, len(edges))


def aperiodicity_spectrum(bap, fs: int, fft_size: int) -> np.ndarray:
    """Coarse band aperiodicity in dB ``(T, n_bands)`` -> the linear
    aperiodicity spectrum ``(T, fft_size // 2 + 1)``: linear
    interpolation over frequency between the band centres, held flat to
    DC and Nyquist (the decode direction of WORLD's coded aperiodicity).
    Host numpy in f64, as in the JAX package; every frame is one product
    with the interpolation's weights."""
    bap = np.asarray(bap, np.float64)
    edges = band_edges(fs)
    freqs = np.fft.rfftfreq(fft_size, 1.0 / fs)
    pts_f = np.concatenate([[0.0], edges, [fs / 2.0]])
    # interpolation is linear in the values: weights of each point
    weights = np.stack([np.interp(freqs, pts_f, e)
                        for e in np.eye(len(pts_f))], axis=1)
    pts_v = np.concatenate([bap[:, :1], bap, bap[:, -1:]], axis=1)
    return np.power(10.0, pts_v @ weights.T / 10.0)


# ---------------------------------------------------------------------------
# D4C aperiodicity (static group delay)
# ---------------------------------------------------------------------------

F0_FLOOR_D4C = 47.0
LOVE_TRAIN_LOWEST_F0 = 40.0
FREQUENCY_INTERVAL = 3000.0


def _nuttall(n: int) -> np.ndarray:
    t = np.arange(n) / max(n - 1, 1)
    return (0.355768 - 0.487396 * np.cos(2 * np.pi * t)
            + 0.144232 * np.cos(4 * np.pi * t)
            - 0.012604 * np.cos(6 * np.pi * t))


def _adaptive_window(offs, half_len, kind: str):
    """Pitch-adaptive window over buffer offsets ``offs`` ``(W,)``, zero
    outside |offs| <= half_len ``(B, T)``: 'blackman' is WORLD's ratio-4
    Blackman, 'hanning' its ratio-3 and ratio-4 Hanning (D4C's
    GetWindowedWaveform)."""
    u = offs / torch.clamp(half_len[..., None], min=1.0)
    inside = (offs.abs() <= half_len[..., None]).float()
    if kind == "blackman":
        w = (0.42 + 0.5 * torch.cos(math.pi * u)
             + 0.08 * torch.cos(2 * math.pi * u))
    else:
        w = 0.5 + 0.5 * torch.cos(math.pi * u)
    return w * inside


def _windowed(xw, win, normalize: bool):
    """Window, remove the window-weighted DC, and optionally scale to unit
    energy (WORLD GetWindowedWaveform)."""
    s = xw * win
    coef = s.sum(-1, keepdim=True) / torch.clamp(
        win.sum(-1, keepdim=True), min=1e-9)
    s = s - win * coef
    if normalize:
        s = s / torch.sqrt(torch.clamp(s.square().sum(-1, keepdim=True),
                                       min=1e-20))
    return s


def _centroid(x, origins, half: int, pad: int, half_len, offs,
              fft_size: int):
    """WORLD D4C GetCentroid: Re{conj(S) F[t s]} of the unit-energy
    Blackman-windowed frame at ``origins``, the time t counted in samples
    from the window's start (WORLD's i + 1)."""
    s = _windowed(_frames_at(x, origins, half, pad),
                  _adaptive_window(offs, half_len, "blackman"),
                  normalize=True)
    spec = torch.fft.rfft(s, fft_size)
    spec_t = torch.fft.rfft(s * (offs + half_len[..., None] + 1.0), fft_size)
    return spec.real * spec_t.real + spec.imag * spec_t.imag


def d4c(x: torch.Tensor, f0: torch.Tensor, fs: int = 24000,
        frame_period_ms: float = 5.0, threshold: float = 0.85
        ) -> torch.Tensor:
    """WORLD D4C coarse band aperiodicity in dB, ``(..., T, n_bands)``
    (Morise 2016; serenade_tpu/ops/world.py:303 states the five steps):
    the LoveTrain voicing gate, the static centroid of two Blackman frames
    T0/4 either side of the frame, the smoothed power spectrum, the
    static group delay and its detrended smoothing, and per 3 kHz band the
    sorted power spectrum of the Nuttall-windowed group delay, whose
    smallest components' share (all but ``round(8 fft / wl)``) gives the
    dB, corrected by (f0 - 100) / 50 and clipped at 0.  Frames at or
    below ``threshold`` or unvoiced are 0 dB."""
    x, f0, lead = _as_batch(x, f0)
    hop = int(fs * frame_period_ms / 1000.0)
    n_frames = f0.shape[-1]
    fft_size = 1 << (1 + int(math.log2(4.0 * fs / F0_FLOOR_D4C + 1.0)))
    half = fft_size // 2
    n_bins = half + 1
    bin_hz = fs / fft_size
    dev = x.device

    if (n_frames - 1) * hop > x.shape[-1]:
        raise ValueError(f"{n_frames} F0 frames at hop {hop} exceed the "
                         f"waveform's {x.shape[-1]} samples")
    f0c = torch.clamp(torch.where(f0 <= 0, F0_FLOOR_D4C, f0),
                      min=F0_FLOOR_D4C)
    centers = (torch.arange(n_frames, device=dev) * hop).expand_as(f0)
    # room for the centroid frames' shifts of up to T0/4 at the floor
    pad = half + int(round(0.25 * fs / F0_FLOOR_D4C)) + 8
    offs = torch.arange(-half, half, device=dev).float()
    xw = _frames_at(x, centers, half, pad)

    # 1. LoveTrain: the power of (100 Hz, 4 kHz] over (100 Hz, 7.9 kHz]
    # of a ratio-3 Hanning frame, bin ceil(100 Hz) itself excluded
    h3 = torch.round(1.5 * fs / torch.clamp(f0c, min=LOVE_TRAIN_LOWEST_F0))
    s3 = _windowed(xw, _adaptive_window(offs, h3, "hanning"),
                   normalize=False)
    p_lt = torch.fft.rfft(s3, fft_size).abs().square().double()
    b0, b1, b2 = (int(np.ceil(f * fft_size / fs))
                  for f in (100.0, 4000.0, 7900.0))
    ap0 = (p_lt[..., b0 + 1:b1 + 1].sum(-1) / torch.clamp(
        p_lt[..., b0 + 1:b2 + 1].sum(-1), min=1e-20)).float()
    suitable = (f0 > 0) & (ap0 > threshold)

    # 2-3. the static centroid and the smoothed power spectrum
    h4 = torch.round(2.0 * fs / f0c)
    shift = torch.round(0.25 * fs / f0c).long()
    cent = (_centroid(x, centers - shift, half, pad, h4, offs, fft_size)
            + _centroid(x, centers + shift, half, pad, h4, offs, fft_size))
    cent = _dc_correct(cent, f0c, bin_hz)
    s4 = _windowed(xw, _adaptive_window(offs, h4, "hanning"),
                   normalize=True)
    power = torch.fft.rfft(s4, fft_size).abs().square()
    power = _linear_smooth(_dc_correct(power, f0c, bin_hz), f0c / bin_hz)

    # 4. the static group delay, smoothed at f0/2 and detrended at f0
    sgd = 0.5 * fs / f0c[..., None] - cent / torch.clamp(power, min=1e-12)
    sgd = _linear_smooth(sgd, 0.5 * f0c / bin_hz)
    sgd = sgd - _linear_smooth(sgd, f0c / bin_hz)

    # 5. coarse aperiodicity per band
    n_bands = len(band_edges(fs))
    wl = int(FREQUENCY_INTERVAL * fft_size / fs) * 2 + 1
    half_wl = wl // 2
    boundary = int(round(fft_size * 8.0 / wl))
    nuttall = torch.as_tensor(_nuttall(wl), dtype=torch.float32, device=dev)
    cols = []
    for band in range(n_bands):
        cb = int(FREQUENCY_INTERVAL * (band + 1) * fft_size / fs)
        seg = sgd[..., cb - half_wl:cb + half_wl + 1] * nuttall
        ps = torch.fft.rfft(seg, fft_size).abs().square()
        ps = torch.sort(ps, dim=-1).values.double()
        ratio = (ps[..., :n_bins - 1 - boundary].sum(-1)
                 / torch.clamp(ps.sum(-1), min=1e-20)).float()
        ap_db = 10.0 * torch.log10(torch.clamp(ratio, min=1e-12))
        cols.append(torch.clamp(ap_db + (f0c - 100.0) / 50.0, max=0.0))
    bap = torch.where(suitable[..., None], torch.stack(cols, dim=-1), 0.0)
    return bap.reshape(*lead, n_frames, n_bands)
