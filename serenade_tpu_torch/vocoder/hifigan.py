"""HiFiGAN generator and discriminators (counterpart of
serenade_tpu/vocoder/hifigan.py).

The discriminators keep the geometry the JAX docstrings record (the
reference's ``hifigan.py:287-881``), weight norm omitted as there.  Each
takes ``(B, T, 1)`` waveforms and returns ``(score, fmaps)``, or a list of
such pairs: channels-last ``(B, T, C)`` for the scale discriminators, as
in JAX, and PyTorch's channels-first ``(B, C, T/p, p)`` for the period
discriminators' 2-D convs, which the losses, means over every element, do
not see.  Modules are named as flax names them, so the
param bridge (``convert.py``) maps a flax tree onto them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from serenade_tpu_torch.models.layers import (
    Conv1d, Conv2d, ConvTranspose1d, as_dtype,
)
from serenade_tpu_torch.vocoder.layers import (
    HiFiGANResidualBlock,
    leaky_relu_01,
)


class HiFiGANGenerator(nn.Module):
    """k7 input conv → per scale [LReLU(0.1) → ConvTranspose → mean of the
    multi-kernel residual blocks] → LReLU(0.01) → k7 conv → tanh."""

    def __init__(self, in_channels: int = 80, out_channels: int = 1,
                 channels: int = 512, kernel_size: int = 7,
                 upsample_scales: Tuple[int, ...] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4),
                 resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11),
                 resblock_dilations: Tuple[Tuple[int, ...], ...] = (
                     (1, 3, 5),) * 3,
                 use_additional_convs: bool = True, dtype=torch.float32,
                 resblock_backend: str = "fused"):
        super().__init__()
        self.dtype = as_dtype(dtype)
        self.in_channels = in_channels
        self.upsample_scales = tuple(upsample_scales)
        self.n_blocks = len(resblock_kernel_sizes)
        self.input_conv = Conv1d(in_channels, channels, kernel_size,
                                 dtype=dtype)
        ch_prev = channels
        for i, (s, k_up) in enumerate(zip(upsample_scales,
                                          upsample_kernel_sizes)):
            ch = channels // (2 ** (i + 1))
            setattr(self, f"upsample_{i}", ConvTranspose1d(
                ch_prev, ch, k_up, stride=s, padding=s // 2 + s % 2,
                output_padding=s % 2, dtype=dtype))
            for j, (k_res, dils) in enumerate(zip(resblock_kernel_sizes,
                                                  resblock_dilations)):
                setattr(self, f"block_{i}_{j}", HiFiGANResidualBlock(
                    k_res, ch, tuple(dils), use_additional_convs,
                    dtype=dtype, backend=resblock_backend))
            ch_prev = ch
        self.output_conv = Conv1d(ch_prev, out_channels, kernel_size,
                                  dtype=dtype)

    def forward(self, c):
        """c ``(B, T, in_channels)`` -> ``(B, T * prod(scales), out)``."""
        x = self.input_conv(c)
        for i in range(len(self.upsample_scales)):
            x = getattr(self, f"upsample_{i}")(leaky_relu_01(x))
            acc = None
            for j in range(self.n_blocks):
                h = getattr(self, f"block_{i}_{j}")(x)
                acc = h if acc is None else acc + h
            x = acc / self.n_blocks
        x = self.output_conv(F.leaky_relu(x, 0.01))
        return torch.tanh(x)


class PeriodDiscriminator(nn.Module):
    """The waveform reflect-padded at its end to a multiple of ``period``,
    folded to ``(T/p, p)`` and run through one ``(k0, 1)`` conv per
    downsample scale (channels x4 to ``max_downsample_channels``), then an
    output conv of kernel ``(k1 - 1, 1)`` with padding ``(k1 - 1) // 2``
    on both sides (the reference's own quirk: an even kernel that
    lengthens the score by a frame)."""

    def __init__(self, period: int = 3, kernel_sizes=(5, 3),
                 channels: int = 32,
                 downsample_scales: Tuple[int, ...] = (3, 3, 3, 3, 1),
                 max_downsample_channels: int = 1024):
        super().__init__()
        self.period = period
        self.n_convs = len(downsample_scales)
        k0, k1 = kernel_sizes
        cin, ch = 1, channels
        for i, s in enumerate(downsample_scales):
            setattr(self, f"conv{i}", Conv2d(cin, ch, (k0, 1), stride=(s, 1),
                                             padding=((k0 - 1) // 2, 0)))
            cin, ch = ch, min(ch * 4, max_downsample_channels)
        self.conv_post = Conv2d(cin, 1, (k1 - 1, 1),
                                padding=((k1 - 1) // 2, 0))

    def forward(self, x):
        b, t, _ = x.shape
        pad = (-t) % self.period
        h = x[..., 0]
        if pad:
            h = F.pad(h[:, None], (0, pad), mode="reflect")[:, 0]
        h = h.reshape(b, 1, -1, self.period)
        fmaps = []
        for i in range(self.n_convs):
            h = leaky_relu_01(getattr(self, f"conv{i}")(h))
            fmaps.append(h)
        h = self.conv_post(h)
        fmaps.append(h)
        return h, fmaps


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Tuple[int, ...] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.n = len(periods)
        for i, p in enumerate(periods):
            setattr(self, f"period{i}", PeriodDiscriminator(period=p))

    def forward(self, x):
        return [getattr(self, f"period{i}")(x) for i in range(self.n)]


class ScaleDiscriminator(nn.Module):
    """A k15 input conv, one grouped k41 conv per downsample scale
    (channels x2 to ``max_downsample_channels``, groups 4 then x4 to
    ``max_groups``), then k5 and k3 output convs."""

    def __init__(self, kernel_sizes=(15, 41, 5, 3), channels: int = 128,
                 max_downsample_channels: int = 1024, max_groups: int = 16,
                 downsample_scales: Tuple[int, ...] = (2, 2, 4, 4, 1)):
        super().__init__()
        self.n_down = len(downsample_scales)
        self.conv0 = Conv1d(1, channels, kernel_sizes[0])
        cin, out_ch, groups = channels, channels, 4
        for i, s in enumerate(downsample_scales):
            setattr(self, f"down{i}", Conv1d(cin, out_ch, kernel_sizes[1],
                                             stride=s, groups=groups))
            cin = out_ch
            out_ch = min(out_ch * 2, max_downsample_channels)
            groups = min(groups * 4, max_groups)
        self.conv_mid = Conv1d(cin, out_ch, kernel_sizes[2])
        self.conv_post = Conv1d(out_ch, 1, kernel_sizes[3])

    def forward(self, x):
        fmaps = []
        h = leaky_relu_01(self.conv0(x))
        fmaps.append(h)
        for i in range(self.n_down):
            h = leaky_relu_01(getattr(self, f"down{i}")(h))
            fmaps.append(h)
        h = leaky_relu_01(self.conv_mid(h))
        fmaps.append(h)
        h = self.conv_post(h)
        fmaps.append(h)
        return h, fmaps


class MultiScaleDiscriminator(nn.Module):
    """``scales`` scale discriminators, the waveform average-pooled
    between them (kernel 4, stride 2, padding 2, the padding counted in
    the mean as flax's ``avg_pool`` with explicit padding counts it)."""

    def __init__(self, scales: int = 3):
        super().__init__()
        self.n = scales
        for i in range(scales):
            setattr(self, f"scale{i}", ScaleDiscriminator())

    def forward(self, x):
        outs = []
        for i in range(self.n):
            outs.append(getattr(self, f"scale{i}")(x))
            if i + 1 < self.n:
                x = F.avg_pool1d(x.transpose(1, 2), 4, 2, padding=2,
                                 count_include_pad=True).transpose(1, 2)
        return outs


class MultiScaleMultiPeriodDiscriminator(nn.Module):
    """HiFiGAN's adversary: the multi-scale outputs, then the
    multi-period ones."""

    def __init__(self):
        super().__init__()
        self.msd = MultiScaleDiscriminator()
        self.mpd = MultiPeriodDiscriminator()

    def forward(self, x):
        return self.msd(x) + self.mpd(x)
