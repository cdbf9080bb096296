"""HiFiGAN generator (counterpart of serenade_tpu/vocoder/hifigan.py
``HiFiGANGenerator``).  The discriminators wait for the training slice."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from serenade_tpu_torch.models.layers import Conv1d, ConvTranspose1d, as_dtype
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
                 use_additional_convs: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = as_dtype(dtype)
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
                    dtype=dtype))
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
