"""ContentVec / HuBERT-base content encoder (counterpart of
serenade_tpu/modules/contentvec.py).

The conv feature extractor (the last conv at stride 1: 10 ms frames at
16 kHz, the reference's stride hack), the feature projection, the
convolutional positional embedding and post-LN transformer layers, as
``nn.Module``s whose submodules carry the flax names (``convert.py`` maps
the flax tree; ``convert_hf_hubert`` maps a Hugging Face ``HubertModel``
state dict).  f32 throughout, as the JAX package builds it; convolutions
as matmuls (``ops/conv_f32.py``), attention as plain tensor operations
with no key mask, so padded frames are attended to, as in JAX.

No weights are downloaded: ``seeded_hf_state_dict`` draws a state dict in
the Hugging Face layout from a seed (``lengyue233/content-vec-best``, the
checkpoint the reference uses, loads the same way when it is on disk).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from serenade_tpu_torch.models.layers import Dense, LayerNorm, NormParams
from serenade_tpu_torch.ops.conv_f32 import conv1d_f32

# HuBERT-base feature extractor: (dim, kernel, stride) per conv layer
FE_LAYERS = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
             (512, 3, 2), (512, 2, 2), (512, 2, 2))


class ConvWeight(nn.Module):
    """A conv kernel ``(Cout, Cin/groups, K)`` and optional bias."""

    def __init__(self, cin: int, cout: int, k: int, groups: int = 1,
                 bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.groups = groups

    def forward(self, x, stride: int = 1, padding=(0, 0)):
        return conv1d_f32(x, self.weight, self.bias, stride=stride,
                          padding=padding, groups=self.groups)


def group_norm_per_channel(h, scale, bias, eps: float = 1e-6):
    """flax ``nn.GroupNorm`` with one channel a group over ``(B, T, C)``:
    statistics over the whole time axis (padding included), the variance
    as E[x^2] - E[x]^2 clipped at 0 (flax's fast variance)."""
    mean = h.mean(dim=1, keepdim=True)
    var = torch.clamp_min(h.square().mean(dim=1, keepdim=True)
                          - mean.square(), 0.0)
    return (h - mean) * (torch.rsqrt(var + eps) * scale) + bias


class FeatureExtractor(nn.Module):
    def __init__(self, last_conv_stride: int = 1):
        super().__init__()
        cin = 1
        self.strides = []
        for i, (dim, k, s) in enumerate(FE_LAYERS):
            setattr(self, f"conv{i}", ConvWeight(cin, dim, k))
            self.strides.append(last_conv_stride if i == len(FE_LAYERS) - 1
                                else s)
            cin = dim
        self.gn = NormParams(FE_LAYERS[0][0])

    def forward(self, x):
        """``(B, T)`` waveform -> ``(B, T', 512)``."""
        h = x.float()[..., None]
        for i, s in enumerate(self.strides):
            h = getattr(self, f"conv{i}")(h, stride=s)
            if i == 0:
                h = group_norm_per_channel(h, self.gn.scale, self.gn.bias)
            h = F.gelu(h)
        return h


# bytes of attention logits one step may hold: long inputs go in chunks
# of queries (each query's row is computed whole, so the numbers are the
# same; a 600 s request's logits would take 170 GB at once)
MAX_LOGIT_BYTES = 1 << 28


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` over ``(x, x)``, no mask."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        for name in ("query", "key", "value", "out"):
            setattr(self, name, Dense(dim, dim))

    def forward(self, x):
        b, t, c = x.shape
        hd = c // self.heads

        def split(y):
            return y.view(b, t, self.heads, hd).transpose(1, 2)

        q = split(self.query(x)) / math.sqrt(hd)
        k, v = split(self.key(x)), split(self.value(x))
        rows = max(1, MAX_LOGIT_BYTES // (b * self.heads * t * 4))
        o = torch.cat([torch.softmax(q[:, :, s:s + rows] @ k.transpose(-1, -2),
                                     dim=-1) @ v
                       for s in range(0, t, rows)], dim=2)
        return self.out(o.transpose(1, 2).reshape(b, t, c))


class TransformerLayer(nn.Module):
    """Post-LN transformer layer (HuBERT base)."""

    def __init__(self, dim: int = 768, heads: int = 12, ffn_dim: int = 3072):
        super().__init__()
        self.attn = Attention(dim, heads)
        self.ln1 = LayerNorm(dim)
        self.fc1 = Dense(dim, ffn_dim)
        self.fc2 = Dense(ffn_dim, dim)
        self.ln2 = LayerNorm(dim)

    def forward(self, x):
        x = self.ln1(x + self.attn(x))
        return self.ln2(x + self.fc2(F.gelu(self.fc1(x))))


class ContentVecEncoder(nn.Module):
    def __init__(self, dim: int = 768, num_layers: int = 12, heads: int = 12,
                 ffn_dim: int = 3072, last_conv_stride: int = 1,
                 pos_conv_kernel: int = 128, pos_conv_groups: int = 16):
        super().__init__()
        self.config = dict(dim=dim, num_layers=num_layers, heads=heads,
                           ffn_dim=ffn_dim, last_conv_stride=last_conv_stride,
                           pos_conv_kernel=pos_conv_kernel,
                           pos_conv_groups=pos_conv_groups)
        conv_dim = FE_LAYERS[-1][0]
        self.feature_extractor = FeatureExtractor(last_conv_stride)
        self.fp_ln = LayerNorm(conv_dim)
        self.fp_proj = Dense(conv_dim, dim)
        self.pos_conv = ConvWeight(dim, dim, pos_conv_kernel,
                                   groups=pos_conv_groups, bias=True)
        self.pos_conv_kernel = pos_conv_kernel
        self.enc_ln = LayerNorm(dim)
        self.layers = nn.ModuleList(TransformerLayer(dim, heads, ffn_dim)
                                    for _ in range(num_layers))

    def forward(self, wav):
        """``(B, T)`` 16 kHz in [-1, 1] -> ``(B, T'', dim)``, 10 ms frames
        with the stride hack."""
        h = self.fp_proj(self.fp_ln(self.feature_extractor(wav)))
        pad = self.pos_conv_kernel // 2
        pos = self.pos_conv(h, padding=(pad, pad))
        if self.pos_conv_kernel % 2 == 0:
            pos = pos[:, :-1, :]
        h = self.enc_ln(h + F.gelu(pos))
        for layer in self.layers:
            h = layer(h)
        return h


# ---------------------------------------------------------------------------
# parameters: Hugging Face HubertModel state dicts
# ---------------------------------------------------------------------------

_HF_LAYER = {"attn.query": "attention.q_proj", "attn.key": "attention.k_proj",
             "attn.value": "attention.v_proj", "attn.out": "attention.out_proj",
             "ln1": "layer_norm", "fc1": "feed_forward.intermediate_dense",
             "fc2": "feed_forward.output_dense", "ln2": "final_layer_norm"}


def _hf_num_layers(state_dict) -> int:
    return sum(1 for k in state_dict
               if k.startswith("encoder.layers.")
               and k.endswith(".attention.q_proj.weight"))


def convert_hf_hubert(state_dict) -> Dict[str, torch.Tensor]:
    """A Hugging Face ``HubertModel`` state dict -> the state dict of
    ``ContentVecEncoder`` (the weight norm of ``pos_conv`` folded, in
    numpy f32 as serenade_tpu/modules/contentvec.py:148-161 folds it)."""
    def t(name):
        return state_dict[name].detach().cpu().numpy().astype(np.float32)

    sd = {}
    for i in range(len(FE_LAYERS)):
        sd[f"feature_extractor.conv{i}.weight"] = t(
            f"feature_extractor.conv_layers.{i}.conv.weight")
    for ours, theirs in (
            ("feature_extractor.gn", "feature_extractor.conv_layers.0."
             "layer_norm"),
            ("fp_ln", "feature_projection.layer_norm"),
            ("enc_ln", "encoder.layer_norm")):
        sd[f"{ours}.scale"] = t(f"{theirs}.weight")
        sd[f"{ours}.bias"] = t(f"{theirs}.bias")
    sd["fp_proj.weight"] = t("feature_projection.projection.weight")
    sd["fp_proj.bias"] = t("feature_projection.projection.bias")
    # weight norm: the parametrizations API or the legacy weight_g/weight_v
    pre = "encoder.pos_conv_embed.conv."
    if pre + "parametrizations.weight.original0" in state_dict:
        g = t(pre + "parametrizations.weight.original0")
        v = t(pre + "parametrizations.weight.original1")
    else:
        g, v = t(pre + "weight_g"), t(pre + "weight_v")
    norm = np.sqrt((v**2).sum(axis=(0, 1), keepdims=True))
    sd["pos_conv.weight"] = g * v / np.maximum(norm, 1e-12)
    sd["pos_conv.bias"] = t(pre + "bias")
    for i in range(_hf_num_layers(state_dict)):
        for ours, theirs in _HF_LAYER.items():
            norm_layer = ours.startswith("ln")
            for ours_p, theirs_p in ((("scale", "weight"), ("bias", "bias"))
                                     if norm_layer else
                                     (("weight", "weight"), ("bias", "bias"))):
                sd[f"layers.{i}.{ours}.{ours_p}"] = t(
                    f"encoder.layers.{i}.{theirs}.{theirs_p}")
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def seeded_hf_state_dict(seed: int = 0, dim: int = 768, num_layers: int = 12,
                         heads: int = 12, ffn_dim: int = 3072,
                         last_conv_stride: int = 1,
                         pos_conv_kernel: int = 128,
                         pos_conv_groups: int = 16) -> Dict[str, torch.Tensor]:
    """Random weights in the Hugging Face ``HubertModel`` layout, from one
    seeded CPU generator, after its initializers: convs He-normal, linears
    N(0, 0.02), norms at identity, biases 0, the positional conv's weight
    norm with g = |v| (the legacy ``weight_g``/``weight_v`` names).
    ``heads`` and ``last_conv_stride`` do not change the layout."""
    del heads, last_conv_stride
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    sd = {}
    cin = 1
    for i, (c, k, _) in enumerate(FE_LAYERS):
        sd[f"feature_extractor.conv_layers.{i}.conv.weight"] = normal(
            (c, cin, k), math.sqrt(2.0 / (cin * k)))
        cin = c
    norms = {"feature_extractor.conv_layers.0.layer_norm": cin,
             "feature_projection.layer_norm": cin,
             "encoder.layer_norm": dim}
    linears = {"feature_projection.projection": (dim, cin)}
    for i in range(num_layers):
        pre = f"encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linears[pre + "attention." + name] = (dim, dim)
        linears[pre + "feed_forward.intermediate_dense"] = (ffn_dim, dim)
        linears[pre + "feed_forward.output_dense"] = (dim, ffn_dim)
        norms[pre + "layer_norm"] = dim
        norms[pre + "final_layer_norm"] = dim
    for name, (o, i_) in linears.items():
        sd[name + ".weight"] = normal((o, i_), 0.02)
        sd[name + ".bias"] = torch.zeros(o)
    for name, n in norms.items():
        sd[name + ".weight"] = torch.ones(n)
        sd[name + ".bias"] = torch.zeros(n)
    cg = dim // pos_conv_groups
    v = normal((dim, cg, pos_conv_kernel),
               2.0 * math.sqrt(1.0 / (pos_conv_kernel * cg)))
    pre = "encoder.pos_conv_embed.conv."
    sd[pre + "weight_v"] = v
    sd[pre + "weight_g"] = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
    sd[pre + "bias"] = torch.zeros(dim)
    sd["masked_spec_embed"] = torch.rand(dim, generator=gen)
    return sd


def load_contentvec_params(model: ContentVecEncoder, params,
                           seed: int = 0) -> ContentVecEncoder:
    """Load ``params`` into ``model``: a path to a ``.pt`` Hugging Face
    state dict (read with ``weights_only=True``), such a state dict, a
    flax tree of the JAX ContentVecEncoder (numpy leaves), the port's own
    state dict, or None for ``seeded_hf_state_dict(seed)`` at the model's
    widths."""
    if params is None:
        params = seeded_hf_state_dict(seed, **model.config)
    elif isinstance(params, (str, bytes)) or hasattr(params, "__fspath__"):
        params = torch.load(params, map_location="cpu", weights_only=True)
    if "feature_extractor.conv_layers.0.conv.weight" in params:
        params = convert_hf_hubert(params)
    elif not all(isinstance(v, torch.Tensor) for v in params.values()):
        from serenade_tpu_torch.convert import contentvec_state_dict_from_flax

        params = contentvec_state_dict_from_flax(params)
    model.load_state_dict(params, strict=True)
    return model

