"""Content encoder: weight-normalized Conv1d + dilated residual stack
(counterpart of serenade_tpu/models/conv1d_resnet.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from serenade_tpu_torch.models.layers import (
    WNConv1d,
    as_dtype,
    reflect_pad_time,
)


def leaky_relu(x):
    return F.leaky_relu(x, 0.2)


class ResnetBlock(nn.Module):
    """LeakyReLU → reflect-pad → dilated k3 WNConv → LeakyReLU → k1 WNConv,
    plus a k1 WNConv shortcut."""

    def __init__(self, dim: int, dilation: int = 1, dtype=torch.float32):
        super().__init__()
        self.dilation = dilation
        self.conv1 = WNConv1d(dim, dim, 3, dilation=dilation, dtype=dtype)
        self.conv2 = WNConv1d(dim, dim, 1, dtype=dtype)
        self.shortcut = WNConv1d(dim, dim, 1, dtype=dtype)

    def forward(self, x):
        h = reflect_pad_time(leaky_relu(x), self.dilation)
        h = self.conv2(leaky_relu(self.conv1(h)))
        return self.shortcut(x) + h


class Conv1dResnet(nn.Module):
    """``(B, T, in_dim) -> (B, T, out_dim)``."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 512,
                 num_layers: int = 2, dtype=torch.float32):
        super().__init__()
        self.dtype = as_dtype(dtype)
        self.conv_in = WNConv1d(in_dim, hidden_dim, 7, dtype=dtype)
        for n in range(num_layers):
            setattr(self, f"resblock{n}",
                    ResnetBlock(hidden_dim, 2 ** n, dtype=dtype))
        self.num_layers = num_layers
        self.conv_out = WNConv1d(hidden_dim, out_dim, 7, dtype=dtype)

    def forward(self, x, lengths=None):
        x = self.conv_in(reflect_pad_time(x.to(self.dtype), 3))
        for n in range(self.num_layers):
            x = getattr(self, f"resblock{n}")(x)
        return self.conv_out(reflect_pad_time(leaky_relu(x), 3))
