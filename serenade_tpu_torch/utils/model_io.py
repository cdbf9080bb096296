"""Partial parameter transfer and freezing (counterpart of
serenade_tpu/utils/model_io.py).

Configs name modules as the JAX package does, by prefixes of "/"-joined
flax paths (``params/encoder``, ``params/cfm_decoder/estimator``; a
prefix matches as a string, as there).  The port maps them onto its
state-dict names through the param bridge's name table
(``convert.flax_paths``): a port tensor is selected when every flax leaf
it is made from starts with one of the prefixes.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Mapping, Sequence

import torch
from torch import nn

from serenade_tpu_torch.convert import flax_paths

logger = logging.getLogger(__name__)


def _selected(paths: Sequence[str], prefixes: Sequence[str]) -> bool:
    """Whether a tensor made of the flax leaves ``paths`` lies under the
    prefixes; a prefix that splits the tensor's leaves is refused."""
    hits = [any(p.startswith(m) for m in prefixes) for p in paths]
    if any(hits) and not all(hits):
        raise ValueError(f"module prefixes {list(prefixes)} select part of "
                         f"the tensor made of {list(paths)}")
    return all(hits)


def filter_modules(model: nn.Module, modules: Sequence[str],
                   names=None) -> List[str]:
    """The prefixes of ``modules``, each checked to match at least one
    flax path of ``model``'s tensors (of those in ``names`` where given);
    raises KeyError naming the ones that match nothing."""
    table = flax_paths(model)
    paths = [p for k, ps in table.items() if names is None or k in names
             for p in ps]
    missing = [m for m in modules if not any(p.startswith(m) for p in paths)]
    if missing:
        raise KeyError(
            f"module prefixes {missing} matched nothing; available roots: "
            f"{sorted({p.split('/')[1] for p in paths})}")
    return list(modules)


def transfer_params(model: nn.Module, src: Mapping[str, torch.Tensor],
                    modules: Sequence[str]) -> Dict[str, torch.Tensor]:
    """``model``'s state dict with the tensors under ``modules`` taken from
    ``src`` (a state dict of the same architecture), shapes checked: a
    mismatch raises ValueError, a tensor missing from ``src`` keeps its
    value with a warning."""
    modules = filter_modules(model, modules, names=set(src))
    out = dict(model.state_dict())
    for name, paths in flax_paths(model).items():
        if not _selected(paths, modules):
            continue
        if name not in src:
            logger.warning("transfer: %s missing in source, keeping init",
                           name)
            continue
        if tuple(src[name].shape) != tuple(out[name].shape):
            raise ValueError(
                f"transfer shape mismatch at {name}: src "
                f"{tuple(src[name].shape)} vs dst {tuple(out[name].shape)}")
        out[name] = src[name]
    return out


def freeze_mask(model: nn.Module, freeze_prefixes: Sequence[str]
                ) -> Dict[str, bool]:
    """Parameter name -> True (trainable) or False (frozen), for
    ``trainers.build_optimizer(config, trainable_mask=...)``."""
    return {name: not _selected(paths, freeze_prefixes)
            for name, paths in flax_paths(model).items()}
