"""Griffin-Lim mel inversion, the checkpoint-free vocoder (counterpart of
serenade_tpu/vocoder/griffin_lim.py ``GriffinLimSynth``).

The log-mel is brought back to linear amplitude, mapped to a magnitude
spectrogram by the pseudo-inverse of the mel basis (negative weights
clipped), raised to ``power`` 1.2, and given a phase by ``n_iter``
Griffin-Lim iterations from zero phase, so the result is deterministic.
Analysis and synthesis are framing and DFT-basis products in f32
(``torch.matmul``, as JAX computes them outside any Pallas kernel); the
inverse STFT overlap-adds the windowed frames and divides by the
overlap-added squared window (``librosa.istft``, ``center=True``), with
``F.fold`` in place of JAX's scatter-add.  Each waveform is scaled so its
peak is at most 0.95.

Selected by a vocoder config with ``generator_type: GriffinLim``
(``vocoder.load_vocoder``); it has no parameters, so the ``Vocoder``
facade, the decode, the server and the training loop's eval samples take
it as they take the HiFiGAN generator.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from serenade_tpu_torch.ops.mel import mel_filterbank
from serenade_tpu_torch.ops.stft import _dft_basis_np, hann_window, reflect_pad


@functools.lru_cache(maxsize=None)
def _synthesis_basis(fft_size: int):
    """The inverse rDFT as two ``(fft_size//2+1, fft_size)`` bases:
    ``x[n] = sum_k w_k (re_k cos - im_k sin)(2 pi k n / N) / N`` with
    ``w_k`` 2 except at DC and Nyquist."""
    n_bins = fft_size // 2 + 1
    k = np.arange(n_bins)[:, None]
    n = np.arange(fft_size)[None, :]
    ang = 2.0 * np.pi * k * n / fft_size
    w = np.full((n_bins, 1), 2.0)
    w[0, 0] = 1.0
    if fft_size % 2 == 0:
        w[-1, 0] = 1.0
    return ((w * np.cos(ang) / fft_size).astype(np.float32),
            (w * np.sin(ang) / fft_size).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _mel_pinv(sr: int, fft_size: int, num_mels: int, fmin: float,
              fmax: float) -> np.ndarray:
    """``(mels, bins)``: the mel basis's pseudo-inverse, negatives at 0."""
    basis = mel_filterbank(sr, fft_size, num_mels, fmin, fmax)
    return np.maximum(np.linalg.pinv(basis.astype(np.float64)),
                      0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _operands(key: tuple, device: torch.device):
    """The window, the analysis and synthesis bases and the pseudo-inverse
    mel basis of one configuration, on ``device``, made once."""
    sr, fft, win, mels, fmin, fmax = key
    cos_b, sin_b = _dft_basis_np(fft)
    icos_b, isin_b = _synthesis_basis(fft)
    return tuple(torch.from_numpy(a).to(device) for a in (
        hann_window(win, fft), cos_b, sin_b, icos_b, isin_b,
        _mel_pinv(sr, fft, mels, fmin, fmax)))


def _stft(y, window, cos_b, sin_b, fft_size: int, hop: int):
    """``(B, L)`` -> re, im ``(B, 1 + L // hop, bins)``: reflect-padded
    by ``fft_size // 2`` on both sides, framed and windowed."""
    fw = reflect_pad(y, fft_size // 2).unfold(-1, fft_size, hop) * window
    return fw @ cos_b, fw @ sin_b


def _istft(re, im, window, icos_b, isin_b, fft_size: int, hop: int,
           out_len: int):
    """Overlap-add inverse of ``_stft``: ``(B, n_frames, bins)`` ->
    ``(B, out_len)``, normalized by the overlap-added squared window."""
    frames = (re @ icos_b - im @ isin_b) * window   # (B, n, fft)
    b, n, _ = frames.shape
    total = (n - 1) * hop + fft_size

    def ola(f):
        return F.fold(f.transpose(1, 2), output_size=(1, total),
                      kernel_size=(1, fft_size), stride=(1, hop))[:, 0, 0]

    y = ola(frames)
    wsq = ola((window * window).expand(1, n, fft_size))
    y = y / torch.clamp_min(wsq, 1e-8)
    pad = fft_size // 2
    return y[:, pad:pad + out_len]


class GriffinLimSynth(nn.Module):
    """``(B, T, num_mels)`` log-mel -> ``(B, T * hop_size, 1)`` waveforms,
    with no parameters (JAX's ``apply(params, c)`` ignores ``params``)."""

    def __init__(self, sampling_rate: int = 24000, fft_size: int = 512,
                 hop_size: int = 240, win_length: int = 480,
                 num_mels: int = 80, fmin: float = 63.0,
                 fmax: float = 12000.0, n_iter: int = 32,
                 log_base: float = 10.0, power: float = 1.2):
        super().__init__()
        self.fft_size, self.hop_size, self.num_mels = (fft_size, hop_size,
                                                       num_mels)
        self.n_iter, self.log_base, self.power = n_iter, log_base, power
        self._key = (sampling_rate, fft_size, win_length, num_mels,
                     float(fmin), float(fmax))

    def forward(self, c):
        fft, hop = self.fft_size, self.hop_size
        window, cos_b, sin_b, icos_b, isin_b, pinv = _operands(
            self._key, c.device)
        c = c.float()
        if self.log_base == 10.0:
            amp_mel = torch.pow(10.0, c)
        elif self.log_base == 2.0:
            amp_mel = torch.pow(2.0, c)
        else:
            amp_mel = torch.exp(c)
        mag = torch.pow(torch.clamp_min(amp_mel @ pinv, 1e-10), self.power)
        n, out_len = mag.shape[1], c.shape[1] * hop
        re, im = mag, torch.zeros_like(mag)
        for _ in range(self.n_iter):
            y = _istft(re, im, window, icos_b, isin_b, fft, hop, out_len)
            re2, im2 = _stft(y, window, cos_b, sin_b, fft, hop)
            re2, im2 = re2[:, :n], im2[:, :n]
            norm = torch.sqrt(re2 * re2 + im2 * im2) + 1e-10
            re, im = mag * re2 / norm, mag * im2 / norm
        y = _istft(re, im, window, icos_b, isin_b, fft, hop, out_len)
        peak = y.abs().amax(dim=1, keepdim=True)
        return (y * (0.95 / torch.clamp_min(peak, 0.95)))[..., None]
