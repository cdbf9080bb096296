"""YAML configs and the model registry (counterpart of
serenade_tpu/config.py).

``load_config`` / ``dump_config`` read and write the recipe's YAML
(``pyyaml``, imported when a file is read or written).  The registry
holds what the port has: a config's ``model_type``, ``trainer_type``,
``collater_type`` and ``dataset_type`` resolve to their classes here, and
a type the JAX package has but the port does not is refused by name.
"""

from __future__ import annotations

import copy
import importlib
import os
from typing import Any, Dict

# kind -> name -> "module:attribute", imported on first resolve
_REGISTRY = {
    "model": {"Serenade": "serenade_tpu_torch.models.serenade:Serenade"},
    "trainer": {"SSCTrainer": "serenade_tpu_torch.trainers.ssc:SSCTrainer"},
    "collater": {
        "SSCCollater": "serenade_tpu_torch.collaters.ssc:SSCCollater"},
    "dataset": {
        "FeatsDataset":
            "serenade_tpu_torch.datasets.feats_dataset:FeatsDataset"},
}
# registered in the JAX package, not ported
_FLUC = "the F0-fluctuation variant is not ported"
_NOT_PORTED = {
    ("model", "SerenadeNew"): "the F0-fluctuation variant (fluc_channels > "
                              "0) is not ported",
    ("trainer", "SSCTrainerNew"): _FLUC,
    ("collater", "SSCCollaterNew"): _FLUC,
    ("dataset", "FeatsDatasetNew"): _FLUC,
}


def resolve(kind: str, name: str):
    """The class a config names; raises with the known names on a miss."""
    if (kind, name) in _NOT_PORTED:
        raise NotImplementedError(f"{kind} {name!r}: "
                                  f"{_NOT_PORTED[kind, name]}")
    try:
        target = _REGISTRY[kind][name]
    except KeyError:
        known = sorted(_REGISTRY.get(kind, {}))
        raise KeyError(f"unknown {kind} {name!r}; registered: {known}") \
            from None
    module, attr = target.split(":")
    return getattr(importlib.import_module(module), attr)


def _yaml():
    try:
        import yaml
    except ImportError as exc:
        raise ImportError("reading or writing YAML configs needs the pyyaml "
                          "package") from exc
    return yaml


def load_config(path: str, overrides: Dict[str, Any] | None = None
                ) -> Dict[str, Any]:
    """Load a YAML config and merge overrides (the overrides win; None
    values are skipped)."""
    with open(path) as f:
        config = _yaml().safe_load(f)
    if overrides:
        config.update({k: v for k, v in overrides.items() if v is not None})
    return config


def dump_config(config: Dict[str, Any], path: str) -> None:
    """Write the effective config with the package's version stamped in."""
    from serenade_tpu_torch import __version__

    config = copy.deepcopy(config)
    config["version"] = __version__
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        _yaml().safe_dump(config, f, sort_keys=False)
