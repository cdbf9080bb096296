"""WORLD-class synthesis: (f0, spectral envelope, aperiodicity) ->
waveform (copied from serenade_tpu/ops/world_synth.py).

A harmonic-plus-noise model for the analysis-synthesis debugging path:

* voiced frames: harmonics at k f0 with amplitudes |H(k f0)| sqrt(1 -
  ap^2), phases accumulated continuously across frames;
* noise: per-frame white noise shaped by |H(w)| ap(w) through an rFFT,
  Hann overlap-add.

Host numpy in f64, as in the JAX package (an offline path; the neural
vocoders are the production path).  Its noise comes from numpy's
``default_rng(seed)``, so it equals JAX's draw for draw.
"""

from __future__ import annotations

import numpy as np


def world_synthesize(
    f0: np.ndarray,
    sp: np.ndarray,
    ap: np.ndarray,
    fs: int = 24000,
    frame_period_ms: float = 5.0,
    max_harmonics: int = 64,
    seed: int = 0,
) -> np.ndarray:
    """Synthesize a waveform.

    Args:
        f0: (T,) Hz, 0 = unvoiced.
        sp: (T, F) spectral envelope power (|H|^2), F = fft//2+1.
        ap: (T, F) aperiodicity in [0, 1] (amplitude ratio).

    Returns:
        (T * hop,) float32 waveform.
    """
    f0 = np.asarray(f0, np.float64).reshape(-1)
    sp = np.asarray(sp, np.float64)
    ap = np.clip(np.asarray(ap, np.float64), 0.0, 1.0)
    T, F = sp.shape
    fft_size = (F - 1) * 2
    hop = int(fs * frame_period_ms / 1000.0)
    n = T * hop
    freqs = np.linspace(0.0, fs / 2.0, F)
    mag = np.sqrt(np.maximum(sp, 1e-16))  # amplitude envelope

    out = np.zeros(n + fft_size, np.float64)

    # ---- harmonic component: continuous-phase additive synthesis ----
    # upsample f0 to sample rate (hold through unvoiced gaps at 0)
    f0_up = np.repeat(f0, hop)[:n]
    voiced_up = f0_up > 0
    f0_safe = np.where(voiced_up, f0_up, 1.0)
    # per-harmonic phase: phi_k[t] = 2*pi*k*cumsum(f0)/fs
    base_phase = 2.0 * np.pi * np.cumsum(f0_safe) / fs
    frame_idx = np.minimum(np.arange(n) // hop, T - 1)
    min_f0 = max(float(f0[f0 > 0].min()) if (f0 > 0).any() else 100.0, 40.0)
    n_harm = int(min(max_harmonics, np.floor(fs / 2.0 / min_f0)))
    harm = np.zeros(n, np.float64)
    periodic_amp = mag * np.sqrt(np.maximum(1.0 - ap**2, 0.0))  # (T, F)
    for k in range(1, n_harm + 1):
        fk = f0_up * k
        audible = voiced_up & (fk < fs / 2.0 - 50.0)
        if not audible.any():
            break
        # amplitude from the envelope at k*f0 per frame (linear interp)
        bins = np.clip(fk / (fs / 2.0) * (F - 1), 0, F - 1.00001)
        lo = bins.astype(np.int64)
        frac = bins - lo
        amp_lo = periodic_amp[frame_idx, lo]
        amp_hi = periodic_amp[frame_idx, np.minimum(lo + 1, F - 1)]
        amp = amp_lo * (1 - frac) + amp_hi * frac
        harm += np.where(audible, amp * np.cos(k * base_phase), 0.0)
    out[:n] += harm

    # ---- noise component: frame-wise spectral shaping + OLA ----
    rng = np.random.default_rng(seed)
    win_len = 2 * hop
    window = np.hanning(win_len)
    noise_amp = mag * ap
    # unvoiced frames are all-noise with the full envelope
    unvoiced = f0 <= 0
    noise_amp[unvoiced] = mag[unvoiced]
    for t in range(T):
        noise = rng.standard_normal(win_len)
        spec = np.fft.rfft(noise, fft_size)
        shaped = np.fft.irfft(spec * noise_amp[t], fft_size)[:win_len]
        # energy normalization: white noise has unit power per bin
        shaped *= 1.0 / np.sqrt(fft_size)
        out[t * hop:t * hop + win_len] += shaped * window
    return out[:n].astype(np.float32)


def anasyn(audio: np.ndarray, fs: int, f0min: float = 70.0,
           f0max: float = 1100.0, shiftms: float = 5.0,
           device=None) -> np.ndarray:
    """Analysis-synthesis round trip: ``utils/signal.world_extract`` (on
    the card unless ``device`` says otherwise), then
    :func:`world_synthesize` on the host."""
    from serenade_tpu_torch.utils.signal import world_extract

    f0, sp, ap, _ = world_extract(audio, fs, f0min, f0max, shiftms,
                                  device=device)
    return world_synthesize(f0, sp, ap, fs, shiftms)
