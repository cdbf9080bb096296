"""Log-mel filterbank and A-weighted loudness (counterpart of
serenade_tpu/ops/mel.py).

Filterbank numerics follow librosa's defaults (Slaney mel scale and area
normalization); loudness follows perceptual_weighting -> db_to_amplitude
-> log-mean, including power_to_db's top_db=80 clip, which takes the max
over each row's whole (padded) signal, as ``jax.vmap`` of the JAX
function does.  Waveforms ``(..., T)``; f32 (see ``ops/stft.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from serenade_tpu_torch.ops.stft import stft_magnitude, stft_power

_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    return np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
        mel)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    return np.where(log_region,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sr: int, fft_size: int, num_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """``(fft_size//2+1, num_mels)`` triangular filters, Slaney-normalized."""
    n_bins = fft_size // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:num_mels + 2] - hz_pts[:num_mels])
    weights = weights * enorm[:, None]
    return weights.T.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on_device(make, args: tuple, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(make(*args)).to(device)


def logmelfilterbank(audio, sampling_rate: int, fft_size: int = 1024,
                     hop_size: int = 256, win_length: int | None = None,
                     num_mels: int = 80, fmin: float | None = None,
                     fmax: float | None = None, eps: float = 1e-10,
                     log_base: float | None = 10.0):
    """Log-mel features ``(..., n_frames, num_mels)``: the amplitude (not
    power) spectrogram times the mel basis, floored at ``eps``, log10 by
    default."""
    fmin = 0.0 if fmin is None else float(fmin)
    fmax = sampling_rate / 2.0 if fmax is None else float(fmax)
    spc = stft_magnitude(audio, fft_size, hop_size, win_length)
    basis = _on_device(mel_filterbank, (sampling_rate, fft_size, num_mels,
                                        fmin, fmax), audio.device)
    mel = torch.clamp_min(spc @ basis, eps)
    if log_base is None:
        return torch.log(mel)
    if log_base == 10.0:
        return torch.log10(mel)
    if log_base == 2.0:
        return torch.log2(mel)
    raise ValueError(f"unsupported log base {log_base}")


@functools.lru_cache(maxsize=None)
def a_weighting(sr: int, fft_size: int, min_db: float = -80.0) -> np.ndarray:
    """IEC-61672 A-weighting curve in dB per rFFT bin (librosa semantics)."""
    f = np.linspace(0.0, sr / 2.0, fft_size // 2 + 1)
    f_sq = f**2
    const = np.array([12194.217, 20.598997, 107.65265, 737.86223]) ** 2
    num = const[0] * f_sq**2
    den = ((f_sq + const[0]) * (f_sq + const[1])
           * np.sqrt((f_sq + const[2]) * (f_sq + const[3])))
    weights = 2.0 + 20.0 * np.log10(
        np.maximum(num / np.maximum(den, 1e-30), 1e-30))
    return np.maximum(weights, min_db).astype(np.float32)


def loudness_extract(audio, sampling_rate: int, hop_length: int,
                     fft_size: int = 2048):
    """Frame-level log A-weighted loudness ``(..., n_frames)``: power STFT
    -> A-weighting dB with the top_db=80 clip against each row's max ->
    amplitude -> log(mean + 1e-5)."""
    power = stft_power(audio, fft_size, hop_length)
    power_db = 10.0 * torch.log10(torch.clamp_min(power, 1e-10))
    row_max = power_db.amax(dim=(-2, -1), keepdim=True)
    power_db = torch.maximum(power_db, row_max - 80.0)
    weighted_db = power_db + _on_device(a_weighting, (sampling_rate,
                                                      fft_size), audio.device)
    amplitude = torch.pow(10.0, 0.5 * weighted_db)
    return torch.log(amplitude.mean(dim=-1) + 1e-5)
