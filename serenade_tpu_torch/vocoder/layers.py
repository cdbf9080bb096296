"""Vocoder conv blocks (counterpart of serenade_tpu/vocoder/layers.py),
channels-last ``(B, T, C)``.

The HiFiGAN residual block has JAX's two backends:

* ``fused`` (inference): each branch runs through the residual-branch
  wrapper, K3 (``ops/resblock_cuda.py``) on the card at every channel
  width, its plain conv chain on the CPU.  K3 has no backward, as the
  Pallas kernel has none: the wrapper refuses, on the card, inputs that
  need a gradient.
* ``conv`` (training): the same branch as K3's plain version
  (``resblock_branch_plain``), a differentiable chain of ``conv1d``
  calls: the counterpart of JAX's ``conv`` lowering, which runs outside
  Pallas.  It is chosen by the caller, never taken in place
  of K3.

Both hold the same parameters.

The other blocks (causal convs, the WaveNet residual block, the MelGAN
residual stack and the ParallelWaveGAN upsampling networks) are kept, as
the JAX package keeps them, so that vocoder checkpoints of those block
types load and convert.  They run no kernel of ours.  Each names its
submodules as flax does, so ``convert.state_dict_from_flax`` maps their
trees."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from serenade_tpu_torch.models.layers import (
    Conv1d, Conv2d, ConvTranspose1d, accum_dtype, as_dtype, conv1d,
    reflect_pad_time,
)
from serenade_tpu_torch.ops.resblock_cuda import (
    resblock_branch, resblock_branch_plain,
)

BACKENDS = ("fused", "conv")


def leaky_relu_01(x):
    return F.leaky_relu(x, 0.1)


class HiFiGANResidualBlock(nn.Module):
    """Per dilation d: LReLU(0.1) → k-conv(dil=d) [→ LReLU → k-conv(dil=1)]
    → +residual."""

    def __init__(self, kernel_size: int = 3, channels: int = 512,
                 dilations: Tuple[int, ...] = (1, 3, 5),
                 use_additional_convs: bool = True, dtype=torch.float32,
                 backend: str = "fused"):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"unknown resblock backend {backend!r}")
        self.backend = backend
        self.kernel_size, self.dilations = kernel_size, tuple(dilations)
        self.use_additional_convs = use_additional_convs
        self.dtype = as_dtype(dtype)
        for i in range(len(self.dilations)):
            setattr(self, f"conv1_{i}",
                    Conv1d(channels, channels, kernel_size, dtype=dtype))
            if use_additional_convs:
                setattr(self, f"conv2_{i}",
                        Conv1d(channels, channels, kernel_size, dtype=dtype))

    def forward(self, x):
        n = len(self.dilations)
        convs1 = [getattr(self, f"conv1_{i}") for i in range(n)]
        convs2 = ([getattr(self, f"conv2_{i}") for i in range(n)]
                  if self.use_additional_convs else convs1)
        x = x.to(self.dtype)
        if self.backend == "conv":
            # K3's plain version, differentiable, on the per-dilation
            # parameters (no stacked copy for autograd to scatter into)
            def cast(convs, key):
                return [getattr(c, key).to(self.dtype) for c in convs]

            return resblock_branch_plain(
                x, cast(convs1, "weight"), cast(convs1, "bias"),
                cast(convs2, "weight"), cast(convs2, "bias"),
                kernel_size=self.kernel_size, dilations=self.dilations,
                use_additional_convs=self.use_additional_convs)
        # the parameters themselves, per dilation: the wrapper prepares its
        # kernel's weights once per version of these tensors
        return resblock_branch(
            x, [c.weight for c in convs1],
            [c.bias for c in convs1], [c.weight for c in convs2],
            [c.bias for c in convs2], kernel_size=self.kernel_size,
            dilations=self.dilations,
            use_additional_convs=self.use_additional_convs)


def _unrounded(conv: Conv1d, x):
    """``conv(x)`` of the operands in the conv's dtype, summed in f32 and
    left there: a sum the output rounds once (XLA fuses the JAX package's
    bf16 conv output into the f32 sum that follows it, unrounded)."""
    dt, acc = conv.dtype, accum_dtype(conv.dtype)

    def operand(t):
        return None if t is None else t.to(dt).to(acc)

    return conv1d(operand(x), operand(conv.weight), operand(conv.bias),
                  dilation=conv.dilation, padding=(conv.padding,) * 2)


class CausalConv1d(nn.Module):
    """Left-padded conv: the output at frame t sees inputs up to t only
    (left pad ``(k-1)·d``, then a conv with padding 0)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 dilation: int = 1, use_bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.conv = Conv1d(in_channels, features, kernel_size,
                           dilation=dilation, padding=0, bias=use_bias,
                           dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, self.pad, 0)))


class CausalConvTranspose1d(nn.Module):
    """Stride-s transposed conv whose output at frame t depends only on
    inputs up to t: the first ``T·stride`` outputs are kept."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int, use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.deconv = ConvTranspose1d(in_channels, features, kernel_size,
                                      stride, padding=0, bias=use_bias,
                                      dtype=dtype)

    def forward(self, x):
        return self.deconv(x)[:, :x.shape[1] * self.stride]


class WaveNetResidualBlock(nn.Module):
    """Gated tanh · sigmoid residual block with optional conditioning
    ``c`` (1×1 ``aux_conv``, no bias); returns
    ``((x + res)·√0.5, skip)``.  ``aux_channels=0`` builds no
    ``aux_conv``: the flax tree of a block never called with ``c`` has
    none."""

    def __init__(self, residual_channels: int = 64, gate_channels: int = 128,
                 skip_channels: int = 64, kernel_size: int = 3,
                 dilation: int = 1, aux_channels: int = 80,
                 use_causal: bool = False, dtype=torch.float32):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation if use_causal else 0
        self.conv = Conv1d(residual_channels, gate_channels, kernel_size,
                           dilation=dilation,
                           padding=0 if use_causal else None, dtype=dtype)
        self.aux_conv = (Conv1d(aux_channels, gate_channels, 1, padding=0,
                                bias=False, dtype=dtype)
                         if aux_channels else None)
        half = gate_channels // 2
        self.res_conv = Conv1d(half, residual_channels, 1, padding=0,
                               dtype=dtype)
        self.skip_conv = Conv1d(half, skip_channels, 1, padding=0,
                                dtype=dtype)

    def forward(self, x, c=None):
        h = self.conv(F.pad(x, (0, 0, self.pad, 0)) if self.pad else x)
        dt = h.dtype
        # the gate's elementwise chain in f32, rounded once, as XLA fuses
        # it in the JAX package
        h = h.to(accum_dtype(dt))
        if c is not None:
            if self.aux_conv is None:
                raise ValueError("conditioning given to a block built with "
                                 "aux_channels=0")
            h = h + self.aux_conv(c)
        a, b = h.chunk(2, dim=-1)
        z = (torch.tanh(a) * torch.sigmoid(b)).to(dt)
        return (x + _unrounded(self.res_conv, z)) * (0.5 ** 0.5), \
            self.skip_conv(z)


class MelGANResidualStack(nn.Module):
    """LReLU(0.2) → reflect pad ``(k-1)//2·d`` → k-conv(dil=d) → LReLU(0.2)
    → 1×1 conv, plus the 1×1 ``shortcut`` of the unactivated input."""

    def __init__(self, channels: int = 32, kernel_size: int = 3,
                 dilation: int = 1, dtype=torch.float32):
        super().__init__()
        self.pad = (kernel_size - 1) // 2 * dilation
        self.conv1 = Conv1d(channels, channels, kernel_size,
                            dilation=dilation, padding=0, dtype=dtype)
        self.conv2 = Conv1d(channels, channels, 1, padding=0, dtype=dtype)
        self.shortcut = Conv1d(channels, channels, 1, padding=0, dtype=dtype)

    def forward(self, x):
        h = F.leaky_relu(x, 0.2)
        if self.pad:
            h = reflect_pad_time(h, self.pad)
        h = self.conv2(F.leaky_relu(self.conv1(h), 0.2))
        return h + self.shortcut(x)


class Stretch2d(nn.Module):
    """Nearest-neighbour repeat of ``(B, T, F)`` in time, and in frequency
    when ``freq_scale > 1``."""

    def __init__(self, time_scale: int, freq_scale: int = 1):
        super().__init__()
        self.time_scale, self.freq_scale = time_scale, freq_scale

    def forward(self, x):
        x = torch.repeat_interleave(x, self.time_scale, dim=1)
        if self.freq_scale > 1:
            x = torch.repeat_interleave(x, self.freq_scale, dim=2)
        return x


class UpsampleNetwork(nn.Module):
    """``(B, T, C)`` → ``(B, T·prod(scales), C)``: for each scale s, a
    repeat in time by s, then a ``(2s+1)``-tap time kernel, no bias,
    shared by every channel (flax's one-channel ``nn.Conv`` of kernel
    ``(2s+1, 1)`` over the ``(T, C)`` image, ``conv{i}``)."""

    def __init__(self, upsample_scales: Sequence[int], dtype=torch.float32):
        super().__init__()
        self.upsample_scales = tuple(upsample_scales)
        for i, s in enumerate(self.upsample_scales):
            setattr(self, f"conv{i}", Conv2d(1, 1, (2 * s + 1, 1),
                                             padding=(s, 0), bias=False,
                                             dtype=dtype))

    def forward(self, c):
        x = c[:, None]                          # (B, 1, T, C)
        for i, s in enumerate(self.upsample_scales):
            x = getattr(self, f"conv{i}")(
                torch.repeat_interleave(x, s, dim=2))
        return x[:, 0]


class ConvInUpsampleNetwork(nn.Module):
    """``conv_in`` (kernel ``2·aux_context_window+1``, padding 0, no bias)
    over the ``aux_channels`` auxiliary features, then
    :class:`UpsampleNetwork`."""

    def __init__(self, upsample_scales: Sequence[int], aux_channels: int = 80,
                 aux_context_window: int = 2, dtype=torch.float32):
        super().__init__()
        self.conv_in = Conv1d(aux_channels, aux_channels,
                              2 * aux_context_window + 1, padding=0,
                              bias=False, dtype=dtype)
        self.upsample = UpsampleNetwork(upsample_scales, dtype=dtype)

    def forward(self, c):
        return self.upsample(self.conv_in(c))
