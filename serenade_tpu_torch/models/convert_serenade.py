"""Reference torch Serenade checkpoints → the port's state dicts
(counterpart of serenade_tpu/models/convert_serenade.py).

The upstream recipe's released checkpoints are torch pickles of its
Serenade (``{"model": state_dict}``).  The port names its modules as the
JAX package's flax tree does, and keeps torch's layouts, so the map is
one of names (the JAX converter's, module by module) plus two merges:

  weight-norm Conv1d  weight_v, weight_g (out, 1, 1)  -> v, g (out,)
                      (or the parametrizations' original1 / original0,
                      or a plain weight with g = its norm)
  GRU l0              bias_ih + bias_hh for the r and z gates -> bias_ih,
                      the n gate's bias_hh -> bias_hn (as flax's GRUCell)
  BatchNorm2d         running_mean, running_var, weight, bias
                      -> mean, var, scale, bias (num_batches_tracked unused)

The GST must then run ``gst_norm_type="frozen_batch"``: the checkpoint's
BatchNorm running statistics, applied exactly.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

from serenade_tpu_torch.models import gst, layers

# port leaf -> reference leaf, per module kind
_LEAVES = {
    "plain": None,                       # the same names
    "norm": {"scale": "weight", "bias": "bias"},
    "bn": {"mean": "running_mean", "var": "running_var", "scale": "weight",
           "bias": "bias"},
}
_KINDS = {layers.Dense: "plain", layers.Conv1d: "plain",
          layers.ConvTranspose1d: "plain", layers.Conv2d: "plain",
          gst.StyleTokenLayer: "plain", layers.NormParams: "norm",
          layers.LayerNorm: "norm", gst.FrozenBatchNorm2d: "bn",
          layers.WNConv1d: "wn", gst.MaskedGRU: "gru"}
_ENCODER_BLOCK = {"conv1": "block.2", "conv2": "block.4",
                  "shortcut": "shortcut"}
# (pattern, replacement) on a port module path, applied in order
_RENAMES = [
    (r"^gst\.ref_enc\.conv(\d+)$",
     lambda m: f"gst.ref_enc.convs.{3 * int(m[1])}"),
    (r"^gst\.ref_enc\.norm(\d+)$",
     lambda m: f"gst.ref_enc.convs.{3 * int(m[1]) + 1}"),
    (r"^gst\.stl\.(linear_\w+)$", r"gst.stl.mha.\1"),
    (r"\.(down|mid|up)(\d+)_resnet", r".\1_blocks.\2.0"),
    (r"\.(down|mid|up)(\d+)_tx(\d+)", r".\1_blocks.\2.1.\3"),
    (r"\.(down|up)(\d+)_(?:downsample|upsample)$", r".\1_blocks.\2.2"),
    (r"\.(block[12]|final_block)\.conv$", r".\1.block.0"),
    (r"\.(block[12]|final_block)\.norm$", r".\1.block.1"),
    (r"(_blocks\.\d+\.0)\.time_mlp$", r"\1.mlp.1"),
    (r"\.speaker_adapter\.w_(scale|bias)$", r".speaker_projection.W_\1"),
    (r"\.attn1\.to_out$", r".attn1.to_out.0"),
    (r"\.ff\.act\.proj$", r".ff.net.0.proj"),
    (r"\.ff\.out$", r".ff.net.2"),
]


def reference_name(name: str, encoder_layers: int = 2) -> str:
    """The reference module path of the port's module ``name``."""
    m = re.fullmatch(r"encoder\.resblock(\d+)\.(\w+)", name)
    if m:
        return f"encoder.model.{2 + int(m[1])}.{_ENCODER_BLOCK[m[2]]}"
    if name == "encoder.conv_in":
        return "encoder.model.1"
    if name == "encoder.conv_out":
        return f"encoder.model.{4 + encoder_layers}"
    for pattern, repl in _RENAMES:
        name = re.sub(pattern, repl, name)
    return name


def _modules(model: torch.nn.Module):
    """(port path, reference path, kind, leaf names) of every module that
    holds parameters."""
    names = [n for n, _ in model.named_modules()]
    enc_layers = sum(bool(re.fullmatch(r"encoder\.resblock\d+", n))
                     for n in names)
    for name, mod in model.named_modules():
        kind = _KINDS.get(type(mod))
        if kind is not None:
            yield (name, reference_name(name, enc_layers), kind,
                   [k for k, _ in mod.named_parameters(recurse=False)])


def _wn_from_reference(sd, p):
    if f"{p}.weight_v" in sd:
        v, g = sd[f"{p}.weight_v"], sd[f"{p}.weight_g"]
    elif f"{p}.parametrizations.weight.original1" in sd:
        v = sd[f"{p}.parametrizations.weight.original1"]
        g = sd[f"{p}.parametrizations.weight.original0"]
    else:          # weight norm already removed: g is the weight's norm
        v = sd[f"{p}.weight"]
        g = torch.linalg.vector_norm(v.float(), dim=(1, 2))
    out = {"v": v, "g": g.reshape(-1)}
    if f"{p}.bias" in sd:
        out["bias"] = sd[f"{p}.bias"]
    return out


def _gru_from_reference(sd, p):
    b_ih, b_hh = sd[f"{p}.bias_ih_l0"].float(), sd[f"{p}.bias_hh_l0"].float()
    h = b_hh.shape[0] // 3
    return {"weight_ih": sd[f"{p}.weight_ih_l0"],
            "weight_hh": sd[f"{p}.weight_hh_l0"],
            # flax's GRUCell folds both biases of r and z into the input
            # projection; n keeps the hidden bias inside r's product
            "bias_ih": torch.cat([b_ih[:2 * h] + b_hh[:2 * h], b_ih[2 * h:]]),
            "bias_hn": b_hh[2 * h:]}


def _skeleton(model_params: Mapping, model_cls=None) -> torch.nn.Module:
    """The port's ``model_cls`` (Serenade by default) for
    ``model_params`` with the frozen-BatchNorm GST, on the meta device
    (names and shapes, no storage)."""
    if model_cls is None:
        from serenade_tpu_torch.models.serenade import Serenade as model_cls

    with torch.device("meta"):
        return model_cls(**dict(model_params, gst_norm_type="frozen_batch"))


def convert_serenade(state_dict: Mapping[str, torch.Tensor],
                     model_params: Mapping, model_cls=None
                     ) -> Dict[str, torch.Tensor]:
    """A reference Serenade (or SerenadeNew: ``model_cls``) state dict ->
    the state dict of the port's ``model_cls(**model_params,
    gst_norm_type="frozen_batch")`` (f32).  Raises KeyError on a tensor
    missing from the reference."""
    sd, out = state_dict, {}
    for name, ref, kind, leaves in _modules(_skeleton(model_params,
                                                      model_cls)):
        if kind == "wn":
            got = _wn_from_reference(sd, ref)
        elif kind == "gru":
            got = _gru_from_reference(sd, ref)
        else:
            rename = _LEAVES[kind] or {k: k for k in leaves}
            got = {k: sd[f"{ref}.{rename[k]}"] for k in leaves}
        for k in leaves:
            out[f"{name}.{k}"] = got[k].detach().float().cpu()
    return out


def to_reference_state_dict(state_dict: Mapping[str, torch.Tensor],
                            model_params: Mapping, model_cls=None
                            ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`convert_serenade`: the port's state dict in
    the reference's names and layouts (weight norm as ``weight_g`` /
    ``weight_v``, the GRU's r and z biases all on the input side)."""
    sd, out = state_dict, {}
    for name, ref, kind, leaves in _modules(_skeleton(model_params,
                                                      model_cls)):
        p = {k: sd[f"{name}.{k}"] for k in leaves}
        if kind == "wn":
            got = {"weight_v": p["v"], "weight_g": p["g"].reshape(-1, 1, 1)}
            if "bias" in p:
                got["bias"] = p["bias"]
        elif kind == "gru":
            h = p["bias_hn"].shape[0]
            got = {"weight_ih_l0": p["weight_ih"],
                   "weight_hh_l0": p["weight_hh"], "bias_ih_l0": p["bias_ih"],
                   "bias_hh_l0": torch.cat([p["bias_hn"].new_zeros(2 * h),
                                            p["bias_hn"]])}
        else:
            rename = _LEAVES[kind] or {k: k for k in leaves}
            got = {rename[k]: v for k, v in p.items()}
            if kind == "bn":
                got["num_batches_tracked"] = torch.tensor(0)
        out.update({f"{ref}.{k}": v.detach().clone()
                    for k, v in got.items()})
    return out


def load_torch_serenade_checkpoint(path: str):
    """The model state dict of a reference torch pickle, from the
    ``{"model": sd}`` layout or a raw state dict.  The pickle is trusted:
    it is loaded with ``weights_only=False``, as the JAX package loads it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        return ckpt["model"]
    return ckpt
