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

from serenade_tpu_torch.ops.primitives import (  # noqa: F401 (re-exported)
    accum_dtype,
    conv1d,
    masked_group_norm,
    mish,
)
from serenade_tpu_torch.quantize import QTensor, int8_dot


def as_dtype(dtype) -> torch.dtype:
    """``torch.bfloat16`` from ``"bfloat16"`` (configs carry names)."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


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
    """``p`` in ``dtype``: itself where it already is (an exported program
    then holds no cast node for it; ``to`` would return it unchanged)."""
    return p if p is None or p.dtype == dtype else p.to(dtype)


class Dense(nn.Module):
    """``QDense`` / ``nn.Dense`` twin: a Linear computed in ``dtype``.

    ``use_int8_`` replaces the weight by its int8 values and per-output
    scales (``quantize.quantize_dense_tree``, the ``int8_compute`` mode):
    the product then runs int8 x int8 (``quantize.int8_dot``) and returns
    ``dtype``, as QDense does with a ``QTensor`` kernel."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if bias
                     else None)
        self.register_buffer("weight_q", None)
        self.register_buffer("weight_scale", None)
        self.dtype = as_dtype(dtype)

    def use_int8_(self, qt: QTensor) -> None:
        self.weight = None
        self.weight_q, self.weight_scale = qt.q, qt.scale

    def forward(self, x):
        dt = self.dtype
        if self.weight_q is not None:
            y = int8_dot(x, QTensor(self.weight_q, self.weight_scale),
                         dtype=dt)
            return y if self.bias is None else y + self.bias.to(dt)
        return F.linear(_cast(x, dt), _cast(self.weight, dt),
                        _cast(self.bias, dt))


class Conv1d(nn.Module):
    """Conv1d with torch-style symmetric padding (None: ``(k-1)//2 * d``),
    grouped by ``groups`` (flax's ``feature_group_count``).  Also the
    parameter holder of Block1D and the HiFiGAN branches."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 padding: Optional[int] = None, bias: bool = True,
                 dtype=torch.float32, groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = ((kernel_size - 1) // 2 * dilation if padding is None
                        else padding)
        self.dtype = as_dtype(dtype)

    def forward(self, x):
        dt = self.dtype
        return conv1d(_cast(x, dt), _cast(self.weight, dt),
                      _cast(self.bias, dt), stride=self.stride,
                      dilation=self.dilation,
                      padding=(self.padding, self.padding),
                      groups=self.groups)


class Conv2d(nn.Module):
    """2-D convolution of channels-first ``(B, C, H, W)`` images (flax's
    NHWC ``nn.Conv`` with explicit padding), weight ``(out, in, kh, kw)``:
    the GST reference encoder's, the period and spectral discriminators'
    and the transcriber's conv stacks, whose feature maps stay in this
    layout."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], stride=(1, 1),
                 padding=(0, 0), dilation=(1, 1), bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.dilation = tuple(dilation)
        self.dtype = as_dtype(dtype)

    def forward(self, x):
        dt = self.dtype
        args = [_cast(t, dt) for t in (x, self.weight, self.bias)]
        # bf16 on the CPU: the bf16 operands summed in f32 and rounded
        # once, as the bf16 conv computes them; oneDNN's bf16 conv2d (torch
        # 2.13) returned NaN for some calls of the GST's stride-2 convs
        # there, varying from call to call on the same inputs
        cpu_bf16 = dt == torch.bfloat16 and x.device.type == "cpu"
        if cpu_bf16:
            args = [_cast(t, torch.float32) for t in args]
        y = F.conv2d(*args, stride=self.stride, padding=self.padding,
                     dilation=self.dilation)
        return y.to(dt) if cpu_bf16 else y


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
        return conv_transpose1d(_cast(x, dt), _cast(self.weight, dt),
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
        return conv1d(_cast(x, dt), kernel, _cast(self.bias, dt),
                      dilation=self.dilation, padding=self.padding)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


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


def compute_weight_dtypes(module: nn.Module) -> dict:
    """The parameters of every Dense / Conv1d / ConvTranspose1d / Conv2d
    (state-dict names) -> the dtype that layer computes in."""
    out = {}
    for name, m in module.named_modules():
        if isinstance(m, (Dense, Conv1d, ConvTranspose1d, Conv2d)):
            for key, _ in m.named_parameters(recurse=False):
                out[f"{name}.{key}" if name else key] = m.dtype
    return out


def store_compute_weights_(module: nn.Module) -> nn.Module:
    """Store the weights of every Dense / Conv1d / ConvTranspose1d in the
    dtype those layers compute in, so a forward pass casts nothing (the same
    values as casting at each use).  Norm parameters, weight-norm ``v``/``g``
    and f32 layers are left as they are."""
    dtypes = compute_weight_dtypes(module)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name in dtypes:
                p.data = p.data.to(dtypes[name])
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
