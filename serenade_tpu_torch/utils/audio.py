"""Waveform I/O, host resampling and the low-cut filter (copied from
serenade_tpu/utils/audio.py).

wav I/O rides scipy, and host resampling is polyphase
(``scipy.signal.resample_poly``), as in the JAX package.  All functions
take float32/float64 mono signals in [-1, 1].
"""

from __future__ import annotations

import math

import numpy as np
from scipy.io import wavfile as _wavfile
from scipy.signal import resample_poly


def read_wav(path):
    """Read a wav file (a path or a file object) -> (audio float32 in
    [-1, 1], ``(T,)`` or ``(T, C)``, sr)."""
    sr, data = _wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    return audio, int(sr)


def write_wav(path, audio, sr: int, subtype: str = "PCM_16") -> None:
    """Write mono/stereo float audio; PCM_16 (default) or FLOAT."""
    audio = np.asarray(audio)
    if subtype == "PCM_16":
        clipped = np.clip(audio, -1.0, 1.0)
        _wavfile.write(path, sr, (clipped * 32767.0).astype(np.int16))
    elif subtype == "FLOAT":
        _wavfile.write(path, sr, audio.astype(np.float32))
    else:
        raise ValueError(f"unsupported subtype: {subtype}")


def to_mono(audio: np.ndarray) -> np.ndarray:
    if audio.ndim == 2:
        return audio.mean(axis=1)
    return audio


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling with the smallest integer up/down ratio."""
    if orig_sr == target_sr:
        return audio
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    return resample_poly(audio, up, down).astype(audio.dtype)


def low_cut_filter(x: np.ndarray, fs: int, cutoff: float = 70.0) -> np.ndarray:
    """High-pass (low-cut) FIR filter: 255 taps of ``firwin`` above
    ``cutoff`` Hz, run by ``lfilter`` (the reference utils/signal.py:13)."""
    from scipy.signal import firwin, lfilter

    taps = firwin(255, cutoff / (fs // 2), pass_zero=False)
    return lfilter(taps, 1, x).astype(x.dtype)
