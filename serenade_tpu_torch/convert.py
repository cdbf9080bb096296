"""Flax parameter trees → the port's state dicts.

The JAX package's parameters (nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, variables)``) map onto the port's modules by
path: the port names its submodules as flax names them.  Layouts are the
inverse of ``serenade_tpu/models/convert_serenade.py``:

  flax Dense    (in, out)          -> weight (out, in)
  flax Conv1d   (k, in, out)       -> weight (out, in, k)
  flax ConvT1d  (k, in, out)       -> weight (in, out, k)
  flax Conv2d   (kh, kw, in, out)  -> weight (out, in, kh, kw)
  grouped Conv1d (k, in/g, out)    -> weight (out, in/g, k)
  BiLSTM fw/bw w_ih (in, 4h), w_hh (h, 4h), b (4h)
                                   -> weight_ih_l0[_reverse] (4h, in),
                                      weight_hh_l0[_reverse] (4h, h),
                                      bias_ih_l0[_reverse] b, bias_hh 0
  weight norm   v (k, in, out), g  -> v (out, in, k), g
  GRUCell ir/iz/in, hr/hz/hn       -> weight_ih, weight_hh (r, z, n rows),
                                      bias_ih (r, z, n), bias_hn (hn bias)

Every mapping is a transpose or a concatenation, so it is linear and
applies to gradients and optimizer updates of the same tree as well.
NUSVC (``models/nusvc.py``), the transformer options (SnakeBeta's
``proj``, ``alpha`` and ``beta``; ``norm2`` and ``attn2``), the GST
attention variants (``modules/gst_attention.py``: ``linear_*``,
``linear_pos``, ``pos_bias_u`` / ``pos_bias_v``), the SiFiGAN generators
(``sifigan/generator.py``), the discriminators (``vocoder/hifigan.py``,
``vocoder/univnet.py``) and the transcriber
(``modules/phoneme_midi/model.py``) name their modules as flax does too,
so their flax trees map by the same table.  JAX folds an LSTM's two
biases into one vector; the bridge puts it in ``bias_ih`` and zeros in
``bias_hh``, which sum to it.

Nothing here imports JAX; the caller converts JAX arrays to numpy.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from serenade_tpu_torch.models import gst, layers, transformer
from serenade_tpu_torch.modules import gst_attention

# port module name -> flax path parts, where flax names it differently
_FLAX_NAMES = {"gru": ("MaskedGRU_0", "GRUCell_0")}


def _lstm(p):
    """torch ``nn.LSTM(bidirectional=True)`` weights from JAX's BiLSTM."""
    out = {}
    for d, suffix in (("fw", ""), ("bw", "_reverse")):
        b = np.asarray(p[f"{d}_b"])
        out[f"weight_ih_l0{suffix}"] = np.asarray(p[f"{d}_w_ih"]).T
        out[f"weight_hh_l0{suffix}"] = np.asarray(p[f"{d}_w_hh"]).T
        out[f"bias_ih_l0{suffix}"] = b
        out[f"bias_hh_l0{suffix}"] = np.zeros_like(b)
    return out


def _with_bias(p, out):
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _gru(p):
    return {
        "weight_ih": np.concatenate([np.asarray(p[g]["kernel"]).T
                                     for g in ("ir", "iz", "in")]),
        "weight_hh": np.concatenate([np.asarray(p[g]["kernel"]).T
                                     for g in ("hr", "hz", "hn")]),
        "bias_ih": np.concatenate([p["ir"]["bias"], p["iz"]["bias"],
                                   p["in"]["bias"]]),
        "bias_hn": p["hn"]["bias"],
    }


_CONVERTERS: Dict[type, Callable[[Mapping], Dict[str, np.ndarray]]] = {
    layers.Dense: lambda p: _with_bias(
        p, {"weight": np.asarray(p["kernel"]).T}),
    layers.Conv1d: lambda p: _with_bias(
        p, {"weight": np.transpose(p["kernel"], (2, 1, 0))}),
    layers.ConvTranspose1d: lambda p: _with_bias(
        p, {"weight": np.transpose(p["kernel"], (1, 2, 0))}),
    layers.WNConv1d: lambda p: _with_bias(
        p, {"v": np.transpose(p["v"], (2, 1, 0)), "g": p["g"]}),
    layers.Conv2d: lambda p: _with_bias(
        p, {"weight": np.transpose(p["kernel"], (3, 2, 0, 1))}),
    nn.LSTM: _lstm,
    layers.NormParams: lambda p: {"scale": p["scale"], "bias": p["bias"]},
    layers.LayerNorm: lambda p: {"scale": p["scale"], "bias": p["bias"]},
    gst.MaskedGroupNorm2d: lambda p: {"scale": p["scale"], "bias": p["bias"]},
    gst.FrozenBatchNorm2d: lambda p: {k: p[k] for k in
                                      ("mean", "var", "scale", "bias")},
    gst.MaskedGRU: _gru,
    gst.StyleTokenLayer: lambda p: {"gst_embs": p["gst_embs"]},
    transformer.SnakeBeta: lambda p: {"alpha": p["alpha"], "beta": p["beta"]},
    gst_attention.RelPositionMultiHeadedAttention: lambda p: {
        "pos_bias_u": p["pos_bias_u"], "pos_bias_v": p["pos_bias_v"]},
}

_POS_BIAS = {"pos_bias_u": ("pos_bias_u",), "pos_bias_v": ("pos_bias_v",)}


# the flax leaves each port tensor is made from, per module type (the
# layouts above aside): port key -> flax leaf paths under the module
_LEAVES: Dict[type, Dict[str, Tuple[str, ...]]] = {
    layers.Dense: {"weight": ("kernel",), "bias": ("bias",)},
    layers.Conv1d: {"weight": ("kernel",), "bias": ("bias",)},
    layers.ConvTranspose1d: {"weight": ("kernel",), "bias": ("bias",)},
    layers.WNConv1d: {"v": ("v",), "g": ("g",), "bias": ("bias",)},
    layers.Conv2d: {"weight": ("kernel",), "bias": ("bias",)},
    layers.NormParams: {"scale": ("scale",), "bias": ("bias",)},
    layers.LayerNorm: {"scale": ("scale",), "bias": ("bias",)},
    gst.MaskedGroupNorm2d: {"scale": ("scale",), "bias": ("bias",)},
    gst.FrozenBatchNorm2d: {k: (k,) for k in ("mean", "var", "scale",
                                               "bias")},
    gst.MaskedGRU: {
        "weight_ih": ("ir/kernel", "iz/kernel", "in/kernel"),
        "weight_hh": ("hr/kernel", "hz/kernel", "hn/kernel"),
        "bias_ih": ("ir/bias", "iz/bias", "in/bias"),
        "bias_hn": ("hn/bias",)},
    gst.StyleTokenLayer: {"gst_embs": ("gst_embs",)},
    transformer.SnakeBeta: {"alpha": ("alpha",), "beta": ("beta",)},
    gst_attention.RelPositionMultiHeadedAttention: _POS_BIAS,
    gst_attention.LegacyRelPositionMultiHeadedAttention: _POS_BIAS,
}


# the axis of each port tensor that its flax leaves' last axis (their
# output channel: Dense (in, out), Conv (k, in, out), an embedding table
# (num, dim)) became in the layouts above; a tensor made of several flax
# leaves (the GRU's gates) stacks them along that axis.  Tensors of one
# dimension are left out: a flax leaf of one dimension has no other axis.
_CHANNEL_AXES: Dict[type, Dict[str, int]] = {
    layers.Dense: {"weight": 0},
    layers.Conv1d: {"weight": 0},
    layers.ConvTranspose1d: {"weight": 1},
    layers.WNConv1d: {"v": 0},
    layers.Conv2d: {"weight": 0},
    gst.MaskedGRU: {"weight_ih": 0, "weight_hh": 0},
    gst.StyleTokenLayer: {"gst_embs": 1},
    gst_attention.RelPositionMultiHeadedAttention: {"pos_bias_u": 1,
                                                    "pos_bias_v": 1},
    gst_attention.LegacyRelPositionMultiHeadedAttention: {"pos_bias_u": 1,
                                                          "pos_bias_v": 1},
}


def flax_leaf_layout(module: nn.Module
                     ) -> Dict[str, Tuple[Optional[int], int]]:
    """Each state-dict key of ``module`` -> (the axis its flax leaves' last
    axis became, or None for a tensor of one dimension; how many flax
    leaves it is made from, each an equal part of it along that axis).
    ``quantize.py`` quantises per flax leaf by it, as the JAX package
    quantises its tree."""
    out = {}
    for name, mod in module.named_modules():
        leaves = _LEAVES.get(type(mod))
        if leaves is None:
            continue
        axes = _CHANNEL_AXES.get(type(mod), {})
        for key, p in mod.named_parameters(recurse=False):
            if p.dim() > 1 and key not in axes:
                raise KeyError(f"no channel axis for {type(mod).__name__}."
                               f"{key}")
            out[f"{name}.{key}" if name else key] = (
                axes.get(key) if p.dim() > 1 else None, len(leaves[key]))
    return out


def flax_paths(module: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """The bridge's name table: each state-dict key of ``module`` -> the
    "/"-joined paths of the flax leaves it is made from, as the JAX
    package names them in a full variables tree (``params/encoder/
    conv_in/kernel``; ``utils/model_io.py`` selects modules by prefixes
    of these)."""
    table = {}
    for name, mod in module.named_modules():
        leaves = _LEAVES.get(type(mod))
        if leaves is None:
            continue
        parts = ["params"] + [key for part in (name.split(".") if name
                                               else ())
                              for key in _FLAX_NAMES.get(part, (part,))]
        own = dict(mod.named_parameters(recurse=False))
        for key, subpaths in leaves.items():
            if key in own:
                table[f"{name}.{key}" if name else key] = tuple(
                    "/".join(parts + [p]) for p in subpaths)
    expected = set(module.state_dict())
    if set(table) != expected:
        raise KeyError(f"no flax path for {sorted(expected - set(table))[:5]}")
    return table


def _lookup(tree: Mapping, name: str) -> Mapping:
    node = tree
    for part in name.split(".") if name else ():
        for key in _FLAX_NAMES.get(part, (part,)):
            node = node[key]
    return node


def state_dict_from_flax(module: nn.Module, params: Mapping
                         ) -> Dict[str, torch.Tensor]:
    """State dict for ``module`` (e.g. ``Serenade``, ``HiFiGANGenerator``)
    from the flax tree of its JAX twin (``{"params": ...}`` or the inner
    dict).  Raises KeyError if a parameter is missing on either side."""
    if set(params) == {"params"}:
        params = params["params"]
    sd = {}
    for name, mod in module.named_modules():
        # a module's own type first, then its bases (BiLSTM is an LSTM)
        conv = next((_CONVERTERS[t] for t in type(mod).__mro__
                     if t in _CONVERTERS), None)
        if conv is None:
            continue
        for key, arr in conv(_lookup(params, name)).items():
            full = f"{name}.{key}" if name else key
            sd[full] = torch.from_numpy(np.array(arr, dtype=np.float32))
    expected = set(module.state_dict())
    if set(sd) != expected:
        raise KeyError(f"missing {sorted(expected - set(sd))[:5]}, "
                       f"unexpected {sorted(set(sd) - expected)[:5]}")
    return sd


def load_params(module: nn.Module, params) -> nn.Module:
    """Load a flax tree (nested dicts) or a state dict (flat ``a.b.c``
    keys) into ``module``."""
    if all(isinstance(v, torch.Tensor) for v in params.values()):
        sd = params
    else:
        sd = state_dict_from_flax(module, params)
    module.load_state_dict(sd, strict=True)
    return module


def contentvec_state_dict_from_flax(params: Mapping
                                    ) -> Dict[str, torch.Tensor]:
    """State dict of ``modules.contentvec.ContentVecEncoder`` from the flax
    tree of serenade_tpu's ContentVecEncoder (``{"params": ...}`` or the
    inner dict): the attention's DenseGeneral kernels ``(dim, heads,
    head_dim)`` and ``(heads, head_dim, dim)`` flattened to Linear
    weights, the rest as above."""
    if set(params) == {"params"}:
        params = params["params"]

    def linear(p):
        k = np.asarray(p["kernel"])
        b = np.asarray(p["bias"])
        if k.ndim == 3 and b.ndim == 2:          # query, key, value
            k = k.reshape(k.shape[0], -1)
        elif k.ndim == 3:                        # out
            k = k.reshape(-1, k.shape[-1])
        return {"weight": k.T, "bias": b.reshape(-1)}

    def norm(p):
        return {"scale": p["scale"], "bias": p["bias"]}

    fe = params["feature_extractor"]
    tree = {f"feature_extractor.conv{i}": {"weight": np.transpose(
        fe[f"conv{i}"]["kernel"], (2, 1, 0))}
        for i in range(sum(1 for k in fe if k.startswith("conv")))}
    tree["feature_extractor.gn"] = norm(fe["gn"])
    tree["fp_ln"], tree["enc_ln"] = norm(params["fp_ln"]), norm(
        params["enc_ln"])
    tree["fp_proj"] = linear(params["fp_proj"])
    tree["pos_conv"] = {
        "weight": np.transpose(params["pos_conv"]["kernel"], (2, 1, 0)),
        "bias": params["pos_conv"]["bias"]}
    i = 0
    while f"layer{i}" in params:
        p = params[f"layer{i}"]
        for name in ("query", "key", "value", "out"):
            tree[f"layers.{i}.attn.{name}"] = linear(p["attn"][name])
        for name in ("ln1", "ln2"):
            tree[f"layers.{i}.{name}"] = norm(p[name])
        for name in ("fc1", "fc2"):
            tree[f"layers.{i}.{name}"] = linear(p[name])
        i += 1
    return {f"{mod}.{key}": torch.from_numpy(np.array(arr, dtype=np.float32))
            for mod, leaves in tree.items() for key, arr in leaves.items()}
