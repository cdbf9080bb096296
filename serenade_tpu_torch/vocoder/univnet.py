"""UnivNet discriminators (counterpart of serenade_tpu/vocoder/univnet.py),
the SiFiGAN recipe's adversary: spectral discriminators at three STFT
resolutions beside HiFiGAN's multi-period discriminator.

Each spectral discriminator runs strided 2-D convs, VALID-padded, over
the magnitude STFT image (frames x bins) of the port's DFT-basis STFT
(``ops/stft.py``), LeakyReLU(0.2) between them.  Defaults follow the
recipe's ``discriminator/univnet.yaml``; weight norm is omitted, as in
JAX.  Feature maps are channels-first ``(B, C, frames, bins)``.
"""

from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F
from torch import nn

from serenade_tpu_torch.models.layers import Conv2d
from serenade_tpu_torch.ops.stft import stft_magnitude
from serenade_tpu_torch.vocoder.hifigan import MultiPeriodDiscriminator


class SpectralDiscriminator(nn.Module):
    def __init__(self, fft_size: int = 1024, hop_size: int = 120,
                 win_length: int = 600, channels: int = 32,
                 kernel_sizes: Tuple[Tuple[int, int], ...] = (
                     (3, 9), (3, 9), (3, 9), (3, 9), (3, 3), (3, 3)),
                 strides: Tuple[Tuple[int, int], ...] = (
                     (1, 1), (1, 2), (1, 2), (1, 2), (1, 1), (1, 1)),
                 negative_slope: float = 0.2):
        super().__init__()
        self.fft_size, self.hop_size = fft_size, hop_size
        self.win_length = win_length
        self.negative_slope = negative_slope
        self.n = len(kernel_sizes)
        self.need = 1 + sum(k[0] - 1 for k in kernel_sizes)
        cin = 1
        for i, (k, s) in enumerate(zip(kernel_sizes, strides)):
            cout = 1 if i == self.n - 1 else channels
            setattr(self, f"conv{i}", Conv2d(cin, cout, k, stride=s))
            cin = cout

    def forward(self, x):
        n_frames = 1 + x.shape[1] // self.hop_size
        if n_frames < self.need:
            # a VALID conv stack on fewer frames leaves an empty score map,
            # whose mean is NaN
            raise ValueError(
                f"segment too short for fft={self.fft_size} hop="
                f"{self.hop_size}: {n_frames} STFT frames < {self.need} "
                f"needed by the VALID conv stack (>= "
                f"{(self.need - 1) * self.hop_size} samples)")
        h = stft_magnitude(x[..., 0], self.fft_size, self.hop_size,
                           self.win_length, dtype=x.dtype)[:, None]
        fmaps = []
        for i in range(self.n):
            h = getattr(self, f"conv{i}")(h)
            if i < self.n - 1:
                h = F.leaky_relu(h, self.negative_slope)
            fmaps.append(h)
        return h, fmaps


class UnivNetMultiResolutionSpectralDiscriminator(nn.Module):
    def __init__(self, fft_sizes: Tuple[int, ...] = (1024, 2048, 512),
                 hop_sizes: Tuple[int, ...] = (120, 240, 50),
                 win_lengths: Tuple[int, ...] = (600, 1200, 240),
                 channels: int = 32):
        super().__init__()
        self.n = len(fft_sizes)
        for i, (fft, hop, win) in enumerate(zip(fft_sizes, hop_sizes,
                                                win_lengths)):
            setattr(self, f"spectral{i}", SpectralDiscriminator(
                fft_size=fft, hop_size=hop, win_length=win,
                channels=channels))

    def forward(self, x):
        return [getattr(self, f"spectral{i}")(x) for i in range(self.n)]


class UnivNetMultiResolutionMultiPeriodDiscriminator(nn.Module):
    """Three spectral resolutions, then the period discriminators."""

    def __init__(self, periods: Tuple[int, ...] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.mrsd = UnivNetMultiResolutionSpectralDiscriminator()
        self.mpd = MultiPeriodDiscriminator(periods=periods)

    def forward(self, x):
        return self.mrsd(x) + self.mpd(x)
