"""Upstream ``midi_model.pt`` state dict -> the port's
``TranscriptionModel`` state dict (counterpart of
serenade_tpu/modules/phoneme_midi/convert.py).

The port keeps PyTorch's layouts, so the weights are copied as they are
and only renamed: a conv stack's ``cnn`` Sequential (conv 0, 3 and 8,
BatchNorm 1, 4 and 9) becomes ``conv0..2`` and ``bn0..2`` (the running
statistics ``mean`` and ``var``, the affine ``scale`` and ``bias``), its
``fc.0`` becomes ``fc``, and a BiLSTM's inner ``rnn`` LSTM is the port's
BiLSTM itself, both biases kept as they are.  A flax tree of the JAX
package's model maps through the param bridge
(``serenade_tpu_torch.convert.state_dict_from_flax``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

_CNN = {"0": "conv0", "1": "bn0", "3": "conv1", "4": "bn1", "8": "conv2",
        "9": "bn2"}
_BN = {"running_mean": "mean", "running_var": "var", "weight": "scale",
       "bias": "bias"}
_CNN_KEY = re.compile(r"(.*)\.cnn\.(\d+)\.(\w+)$")


def _rename(key: str):
    """The port's name of an upstream key, or None for one it drops."""
    m = _CNN_KEY.fullmatch(key)
    if m:
        prefix, idx, leaf = m.groups()
        mod = _CNN[idx]
        if mod.startswith("bn"):
            if leaf == "num_batches_tracked":
                return None
            leaf = _BN[leaf]
        return f"{prefix}.{mod}.{leaf}"
    if ".fc.0." in key:
        return key.replace(".fc.0.", ".fc.")
    return key.replace(".rnn.weight", ".weight").replace(".rnn.bias",
                                                         ".bias")


def load_upstream_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict (f32) from the upstream model's."""
    out = {}
    for key, value in state_dict.items():
        name = _rename(key)
        if name is not None:
            out[name] = value.detach().float().cpu()
    return out


def to_upstream_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`load_upstream_state_dict`: the port's weights
    in the upstream names, BatchNorms with ``num_batches_tracked`` 0."""
    inv_cnn = {v: k for k, v in _CNN.items()}
    inv_bn = {v: k for k, v in _BN.items()}
    out = {}
    for key, value in state_dict.items():
        module, leaf = key.rsplit(".", 1)
        parent, _, mod = module.rpartition(".")
        value = value.detach().clone()
        if parent.endswith("conv_stack") and mod in inv_cnn:
            idx = inv_cnn[mod]
            if mod.startswith("bn"):
                leaf = inv_bn[leaf]
                out[f"{parent}.cnn.{idx}.num_batches_tracked"] = \
                    torch.tensor(0)
            out[f"{parent}.cnn.{idx}.{leaf}"] = value
        elif parent.endswith("conv_stack") and mod == "fc":
            out[f"{module}.0.{leaf}"] = value
        elif re.match(r"(weight|bias)_(ih|hh)_l0", leaf):
            out[f"{module}.rnn.{leaf}"] = value
        else:
            out[key] = value
    return out
