"""Shared building blocks (counterpart of serenade_tpu/models/layers.py).

Activations are channels-last ``(B, T, C)`` at every public function, as
in the JAX package.  Parameters are stored float32 in PyTorch's own
layouts (Linear ``(out, in)``, Conv1d ``(out, in, k)``, ConvTranspose1d
``(in, out, k)``); each module casts them to its compute ``dtype`` at use,
as flax does with ``param_dtype=float32``, unless ``store_compute_weights_``
stored them in that dtype once (the Converter does, so a bf16 forward pass
casts no weights; training keeps the f32 master weights and never does).
``convert.py`` maps the flax parameter tree onto these modules.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def as_dtype(dtype) -> torch.dtype:
    """``torch.bfloat16`` from ``"bfloat16"`` (configs carry names)."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def accum_dtype(dtype) -> torch.dtype:
    """The type sums accumulate in: f32, or f64 for f64 inputs (gradient
    checks)."""
    return torch.promote_types(dtype, torch.float32)


def mish(x):
    """x * tanh(softplus(x)), in one kernel."""
    return F.mish(x)


def dropout(x, p: float, generator: Optional[torch.Generator]):
    """flax ``nn.Dropout`` in training: keep each element with probability
    ``1 - p`` and scale the kept ones by ``1 / (1 - p)``.  The mask comes
    from ``generator`` (on x's device), so a run is reproducible; it cannot
    reproduce the TPU's bits."""
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


# ---------------------------------------------------------------------------
# convolution primitives
# ---------------------------------------------------------------------------


def conv1d(x, weight, bias=None, *, stride: int = 1, dilation: int = 1,
           padding: Tuple[int, int] = (0, 0)):
    """1-D convolution of ``(B, T, Cin)`` by a ``(Cout, Cin, K)`` kernel with
    explicit (torch) padding; returns ``(B, T', Cout)``."""
    h = x.transpose(1, 2)
    if padding != (0, 0):
        h = F.pad(h, padding)
    return F.conv1d(h, weight, bias, stride=stride,
                    dilation=dilation).transpose(1, 2)


def conv_transpose1d(x, weight, bias=None, *, stride: int = 2,
                     padding: int = 1, output_padding: int = 0):
    """Transposed conv with torch geometry, ``(Cin, Cout, K)`` kernel:
    ``out_len = (T - 1) * stride - 2 * padding + K + output_padding``."""
    return F.conv_transpose1d(x.transpose(1, 2), weight, bias, stride=stride,
                              padding=padding,
                              output_padding=output_padding).transpose(1, 2)


def reflect_pad_time(x, pad: int):
    """Reflection-pad the time axis of ``(B, T, C)``."""
    return F.pad(x.transpose(1, 2), (pad, pad), mode="reflect").transpose(1, 2)


def _cast(p: Optional[torch.Tensor], dtype):
    return None if p is None else p.to(dtype)


class Dense(nn.Module):
    """``QDense`` / ``nn.Dense`` twin: a Linear computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if bias
                     else None)
        self.dtype = as_dtype(dtype)

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv1d(nn.Module):
    """Conv1d with torch-style symmetric padding (None: ``(k-1)//2 * d``).
    Also the parameter holder of Block1D and the HiFiGAN branches."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 padding: Optional[int] = None, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.stride, self.dilation = stride, dilation
        self.padding = ((kernel_size - 1) // 2 * dilation if padding is None
                        else padding)
        self.dtype = as_dtype(dtype)

    def forward(self, x):
        dt = self.dtype
        return conv1d(x.to(dt), self.weight.to(dt), _cast(self.bias, dt),
                      stride=self.stride, dilation=self.dilation,
                      padding=(self.padding, self.padding))


class ConvTranspose1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, output_padding: int = 0,
                 bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        self.dtype = as_dtype(dtype)

    def forward(self, x):
        dt = self.dtype
        return conv_transpose1d(x.to(dt), self.weight.to(dt),
                                _cast(self.bias, dt), stride=self.stride,
                                padding=self.padding,
                                output_padding=self.output_padding)


class WNConv1d(nn.Module):
    """Weight-normalized conv1d: ``kernel = g * v / ||v||`` with the norm
    over (Cin, K) per output channel, stored as ``v``/``g``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, padding: Tuple[int, int] = (0, 0),
                 bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.v = nn.Parameter(torch.empty(out_channels, in_channels,
                                          kernel_size))
        self.g = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.dilation, self.padding = dilation, padding
        self.dtype = as_dtype(dtype)

    def forward(self, x):
        dt = self.dtype
        norm = torch.sqrt(torch.sum(self.v * self.v, dim=(1, 2), keepdim=True)
                          + 1e-12)
        kernel = (self.g[:, None, None] * self.v / norm).to(dt)
        return conv1d(x.to(dt), kernel, _cast(self.bias, dt),
                      dilation=self.dilation, padding=self.padding)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


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


class NormParams(nn.Module):
    """``scale``/``bias`` of a GroupNorm (the MaskedGroupNorm twin)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))


class LayerNorm(NormParams):
    """LayerNorm over channels with f32 statistics."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 dtype=torch.float32):
        super().__init__(features)
        self.epsilon = epsilon
        self.dtype = as_dtype(dtype)

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias,
                            self.epsilon).to(self.dtype)


class SpeakerAdaLayerNorm(nn.Module):
    """Per-frame LayerNorm whose scale/bias are predicted (in f32) from the
    style embedding (AdaSpeech2 conditional LayerNorm)."""

    def __init__(self, features: int, spk_dim: int, epsilon: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.w_scale = Dense(spk_dim, features)
        self.w_bias = Dense(spk_dim, features)
        self.epsilon = epsilon
        self.dtype = as_dtype(dtype)

    def forward(self, x, spk):
        y = F.layer_norm(x.float(), (x.shape[-1],), eps=self.epsilon)
        spk = spk.float()
        y = torch.addcmul(self.w_bias(spk)[:, None, :], y,
                          self.w_scale(spk)[:, None, :])
        return y.to(self.dtype)


# ---------------------------------------------------------------------------
# timestep embedding
# ---------------------------------------------------------------------------


def sinusoidal_time_embedding(t, dim: int, scale: float = 1000.0):
    """``(B,)`` flow times -> ``(B, dim)`` sin‖cos embedding."""
    assert dim % 2 == 0
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - 1))
    args = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    """2-layer SiLU MLP over the sinusoidal embedding."""

    def __init__(self, in_features: int, time_embed_dim: int,
                 dtype=torch.float32):
        super().__init__()
        self.linear_1 = Dense(in_features, time_embed_dim, dtype=dtype)
        self.linear_2 = Dense(time_embed_dim, time_embed_dim, dtype=dtype)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


def store_compute_weights_(module: nn.Module) -> nn.Module:
    """Store the weights of every Dense / Conv1d / ConvTranspose1d in the
    dtype those layers compute in, so a forward pass casts nothing (the same
    values as casting at each use).  Norm parameters, weight-norm ``v``/``g``
    and f32 layers are left as they are."""
    from serenade_tpu_torch.models.gst import Conv2d

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Dense, Conv1d, ConvTranspose1d, Conv2d)):
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(m.dtype)
    return module


# ---------------------------------------------------------------------------
# seeded random parameters (no released weights are downloaded)
# ---------------------------------------------------------------------------


def init_params_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter from one seeded CPU generator, in
    ``named_parameters`` order: weights ~ N(0, 1/fan_in), biases 0, norm
    scales and weight-norm gains 1, style tokens N(0, 1), and the
    SpeakerAdaLayerNorm projections at identity (weights 0, scale bias 1)
    as in the flax initializers."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("w_scale.bias") or leaf in ("scale", "g", "var"):
                p.fill_(1.0)
            elif (leaf in ("bias", "mean") or leaf.startswith("bias_")
                  or name.endswith(("w_scale.weight", "w_bias.weight"))):
                p.zero_()
            elif leaf == "gst_embs":
                p.copy_(torch.randn(p.shape, generator=gen))
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen)
                        / math.sqrt(fan_in))
    return module
