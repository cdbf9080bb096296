"""YAML configs and the model registry (counterpart of
serenade_tpu/config.py).

``load_config`` / ``dump_config`` read and write the recipe's YAML
(``pyyaml``, imported when a file is read or written).  The registry
holds what the port has: a config's ``model_type``, ``trainer_type``,
``collater_type`` and ``dataset_type`` resolve to their classes here (the
JAX package's four pairs, the F0-fluctuation variant's ``*New`` types
among them, and the legacy ``NUSVC`` model).  Users add their own
components with ``@register(kind, name)``; ``resolve`` then finds them by
the config's name.  The built-ins stay ``"module:attribute"`` strings,
imported when first resolved, so that reading a config imports no model.
"""

from __future__ import annotations

import copy
import importlib
import os
from typing import Any, Callable, Dict

# kind -> name -> the object, or "module:attribute" imported on first
# resolve (the built-ins)
_REGISTRY: Dict[str, Dict[str, Any]] = {
    "model": {
        "Serenade": "serenade_tpu_torch.models.serenade:Serenade",
        "SerenadeNew": "serenade_tpu_torch.models.serenade_new:SerenadeNew",
        "NUSVC": "serenade_tpu_torch.models.nusvc:NUSVC"},
    "trainer": {
        "SSCTrainer": "serenade_tpu_torch.trainers.ssc:SSCTrainer",
        "SSCTrainerNew": "serenade_tpu_torch.trainers.ssc:SSCTrainerNew"},
    "collater": {
        "SSCCollater": "serenade_tpu_torch.collaters.ssc:SSCCollater",
        "SSCCollaterNew": "serenade_tpu_torch.collaters.ssc:SSCCollaterNew"},
    "dataset": {
        "FeatsDataset":
            "serenade_tpu_torch.datasets.feats_dataset:FeatsDataset",
        "FeatsDatasetNew":
            "serenade_tpu_torch.datasets.feats_dataset:FeatsDatasetNew"},
}


def register(kind: str, name: str | None = None) -> Callable:
    """Decorator: ``@register("model", "MyModel")`` (the name defaults to
    the object's own) makes a config's ``model_type: MyModel`` resolve to
    it."""

    def wrap(obj):
        _REGISTRY.setdefault(kind, {})[name or obj.__name__] = obj
        return obj

    return wrap


def _load(target):
    if not isinstance(target, str):
        return target
    module, attr = target.split(":")
    return getattr(importlib.import_module(module), attr)


def resolve(kind: str, name: str):
    """The class a config names; raises with the known names on a miss."""
    try:
        target = _REGISTRY[kind][name]
    except KeyError:
        known = sorted(_REGISTRY.get(kind, {}))
        raise KeyError(f"unknown {kind} {name!r}; registered: {known}") \
            from None
    return _load(target)


def registered(kind: str) -> Dict[str, Any]:
    """The kind's table, name -> object (the built-ins imported)."""
    return {name: _load(target)
            for name, target in _REGISTRY.get(kind, {}).items()}


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
