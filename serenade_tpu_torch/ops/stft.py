"""STFT as framing + DFT-basis matmul (counterpart of serenade_tpu/ops/stft.py).

Reflect-pad, take frames as a strided view, multiply by the window and by
the real and imaginary DFT bases: two dense f32 matmuls, the form the JAX
package computes.  Semantics of ``librosa.stft(center=True,
pad_mode="reflect")`` with a periodic Hann window zero-padded to
``fft_size``.  Every function takes ``(..., T)`` waveforms and returns
``(..., n_frames, bins)``.

Precision: the feature path computes in f32 at PyTorch's default matmul
precision ("highest", no TF32) and sends no convolution to cuDNN, whose
default on the card is TF32 (see ``ops/conv_f32.py``).  It sets no global
flag, so it holds in every thread of a server.  One step departs from
f32: the DFT-basis products take JAX's f32 operands (windowed frames,
basis) but sum in f64 and round once to f32.  Summed in f32, the
512-2048 products leave the spectrum's quiet bins to the summation
order: 70-80 dB under a frame's peak PyTorch's f32 sums on the CPU are
1.2e-4 off in log10 mel and XLA's 4.2e-5, against f64 sums of the same
operands (``tests/test_torch_features.py`` prints them).  Summed in f64
the port is within 3e-7 of those at every depth on the CPU, and the
card's log-mel within 4.8e-7 of the CPU's (``chip_smoke.py`` phase 3b).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _dft_basis_np(fft_size: int):
    """Real/imag DFT analysis basis, ``(fft_size, fft_size//2+1)`` each."""
    n = np.arange(fft_size)[:, None]
    k = np.arange(fft_size // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / fft_size
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int, fft_size: int) -> np.ndarray:
    """Periodic Hann of ``win_length`` centered in ``fft_size`` zeros
    (librosa window handling)."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    pad = (fft_size - win_length) // 2
    out = np.zeros(fft_size, np.float32)
    out[pad:pad + win_length] = w
    return out


@functools.lru_cache(maxsize=None)
def _operands(fft_size: int, win_length: int, device: torch.device):
    """(f32 window, cos and sin bases as one ``(fft_size, 2 * bins)``
    matrix of their f32 values held in f64) on ``device``, made once."""
    cos_b, sin_b = _dft_basis_np(fft_size)
    basis = np.concatenate([cos_b, sin_b], axis=1).astype(np.float64)
    return (torch.from_numpy(hann_window(win_length, fft_size)).to(device),
            torch.from_numpy(basis).to(device))


def reflect_pad(audio, pad: int):
    """``(..., T)`` reflect-padded by ``pad`` on both sides, reflecting
    again where ``pad >= T`` (numpy's and ``jnp.pad``'s "reflect": the
    signal extended with period ``2 (T - 1)``), which ``F.pad`` refuses."""
    t = audio.shape[-1]
    if pad < t:
        shape = audio.shape
        out = F.pad(audio.reshape(-1, 1, t), (pad, pad), mode="reflect")
        return out.reshape(*shape[:-1], out.shape[-1])
    period = 2 * (t - 1)
    idx = torch.remainder(torch.arange(-pad, t + pad, device=audio.device),
                          period)
    return audio[..., torch.where(idx >= t, period - idx, idx)]


def frame_signal(audio, fft_size: int, hop_size: int, center: bool = True):
    """``(..., T)`` -> frames ``(..., n_frames, fft_size)``, a strided view
    of the centered, reflect-padded signal."""
    if center:
        audio = reflect_pad(audio, fft_size // 2)
    return audio.unfold(-1, fft_size, hop_size)


def stft_power(audio, fft_size: int, hop_size: int,
               win_length: int | None = None, center: bool = True,
               dtype=torch.float32):
    """Power spectrogram ``|STFT|^2``, ``(..., n_frames, fft_size//2+1)``,
    framed and returned in ``dtype`` (the DFT sums in f64 either way)."""
    win_length = win_length or fft_size
    window, basis = _operands(fft_size, win_length, audio.device)
    fw = frame_signal(audio.to(dtype), fft_size, hop_size, center) * window
    re, im = (fw.double() @ basis).to(dtype).chunk(2, dim=-1)
    return re * re + im * im


def stft_magnitude(audio, fft_size: int, hop_size: int,
                   win_length: int | None = None, center: bool = True,
                   dtype=torch.float32):
    return torch.sqrt(stft_power(audio, fft_size, hop_size, win_length,
                                 center, dtype) + 1e-30)
