"""Array primitives shared by the model layers and the kernels' plain
versions (counterpart of the functions of serenade_tpu/models/layers.py
that the Pallas kernels' references call).

They live apart from ``models/`` so that the kernels' modules, and the
custom ops an exported artifact calls (``ops/custom_ops.py``), import no
model code.  Activations are channels-last ``(B, T, C)``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def accum_dtype(dtype) -> torch.dtype:
    """The type sums accumulate in: f32, or f64 for f64 inputs (gradient
    checks)."""
    return torch.promote_types(dtype, torch.float32)


def mish(x):
    """x * tanh(softplus(x)), in one kernel."""
    return F.mish(x)


def conv1d(x, weight, bias=None, *, stride: int = 1, dilation: int = 1,
           padding: Tuple[int, int] = (0, 0), groups: int = 1):
    """1-D convolution of ``(B, T, Cin)`` by a ``(Cout, Cin / groups, K)``
    kernel with explicit (torch) padding; returns ``(B, T', Cout)``."""
    h = x.transpose(1, 2)
    if padding != (0, 0):
        h = F.pad(h, padding)
    return F.conv1d(h, weight, bias, stride=stride, dilation=dilation,
                    groups=groups).transpose(1, 2)


def masked_group_norm(x, mask, scale, bias, *, num_groups: int = 8,
                      epsilon: float = 1e-5, out_dtype=None):
    """GroupNorm over (time, channels/group) with f32 (f64 for f64 input)
    statistics over the valid frames of ``mask`` ``(B, T, 1)`` only;
    variance in two passes."""
    b, t, c = x.shape
    g = num_groups
    assert c % g == 0, f"channels {c} not divisible by groups {g}"
    acc = accum_dtype(x.dtype)
    xf = x.to(acc).reshape(b, t, g, c // g)
    if mask is None:
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = torch.square(xf - mean).mean(dim=(1, 3), keepdim=True)
    else:
        m = mask.to(acc).reshape(b, t, 1, 1)
        denom = torch.clamp(m.sum(dim=1, keepdim=True) * (c // g), min=1.0)
        mean = (xf * m).sum(dim=(1, 3), keepdim=True) / denom
        var = (torch.square(xf - mean) * m).sum(dim=(1, 3),
                                                keepdim=True) / denom
    y = (xf - mean) * torch.rsqrt(var + epsilon)
    y = y.reshape(b, t, c) * scale.to(acc) + bias.to(acc)
    if mask is not None:
        y = y * mask
    return y.to(out_dtype if out_dtype is not None else x.dtype)
