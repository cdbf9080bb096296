"""Flax parameter trees → the port's state dicts.

The JAX package's parameters (nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, variables)``) map onto the port's modules by
path: the port names its submodules as flax names them.  Layouts are the
inverse of ``serenade_tpu/models/convert_serenade.py``:

  flax Dense    (in, out)          -> weight (out, in)
  flax Conv1d   (k, in, out)       -> weight (out, in, k)
  flax ConvT1d  (k, in, out)       -> weight (in, out, k)
  flax Conv2d   (kh, kw, in, out)  -> weight (out, in, kh, kw)
  weight norm   v (k, in, out), g  -> v (out, in, k), g
  GRUCell ir/iz/in, hr/hz/hn       -> weight_ih, weight_hh (r, z, n rows),
                                      bias_ih (r, z, n), bias_hn (hn bias)

Every mapping is a transpose or a concatenation, so it is linear and
applies to gradients and optimizer updates of the same tree as well.

Nothing here imports JAX; the caller converts JAX arrays to numpy.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch
from torch import nn

from serenade_tpu_torch.models import gst, layers

# port module name -> flax path parts, where flax names it differently
_FLAX_NAMES = {"gru": ("MaskedGRU_0", "GRUCell_0")}


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
    gst.Conv2d: lambda p: {"weight": np.transpose(p["kernel"], (3, 2, 0, 1))},
    layers.NormParams: lambda p: {"scale": p["scale"], "bias": p["bias"]},
    layers.LayerNorm: lambda p: {"scale": p["scale"], "bias": p["bias"]},
    gst.MaskedGroupNorm2d: lambda p: {"scale": p["scale"], "bias": p["bias"]},
    gst.FrozenBatchNorm2d: lambda p: {k: p[k] for k in
                                      ("mean", "var", "scale", "bias")},
    gst.MaskedGRU: _gru,
    gst.StyleTokenLayer: lambda p: {"gst_embs": p["gst_embs"]},
}


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
        conv = _CONVERTERS.get(type(mod))
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
