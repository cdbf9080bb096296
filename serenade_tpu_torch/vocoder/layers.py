"""HiFiGAN residual block (counterpart of serenade_tpu/vocoder/layers.py
``HiFiGANResidualBlock``), with JAX's two backends:

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

Both hold the same parameters."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from serenade_tpu_torch.models.layers import Conv1d, as_dtype
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
