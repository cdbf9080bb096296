"""Checkpoint save/restore, the params side (counterpart of
serenade_tpu/checkpoint.py).

The same step-named directories as the JAX package,
``<root>/checkpoint-<steps>steps``, found by step number.  Each holds one
``torch.save`` file, ``checkpoint.pt``: ``{"params": <state dict of the
port's model>, "opt_state": ..., "meta": {"step", "epochs"}}``.  An Orbax
directory written by the JAX package cannot be read without JAX: it is
refused by name, and its params cross through the param bridge
(``serenade_tpu_torch.convert``) instead.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

CHECKPOINT_FILE = "checkpoint.pt"
_STEP_DIR = re.compile(r"checkpoint-(\d+)steps")
# files Orbax writes at the top of a checkpoint directory
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"checkpoint-{step}steps")


def save_checkpoint(root: str, step: int, params, opt_state=None,
                    epochs: int = 0) -> str:
    """Write ``params`` (a state dict) and ``opt_state`` under
    ``<root>/checkpoint-<step>steps``; returns that directory."""
    path = _ckpt_dir(root, step)
    os.makedirs(path, exist_ok=True)
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    state["meta"] = {"step": int(step), "epochs": int(epochs)}
    tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
    return path


def restore_checkpoint(path: str) -> dict:
    """The checkpoint dict saved under ``path`` (its tensors on the CPU)."""
    file = os.path.join(path, CHECKPOINT_FILE)
    if not os.path.exists(file):
        if os.path.isdir(path) and any(
                os.path.exists(os.path.join(path, m))
                for m in _ORBAX_MARKERS):
            raise ValueError(
                f"{path} is an Orbax checkpoint of the JAX package, which "
                "cannot be read without JAX: restore its params there and "
                "map them with serenade_tpu_torch.convert."
                "state_dict_from_flax (the param bridge)")
        raise FileNotFoundError(f"no {CHECKPOINT_FILE} in {path}")
    return torch.load(file, map_location="cpu", weights_only=True)


def restore_params_only(path: str) -> dict:
    """The ``params`` state dict of a checkpoint."""
    return restore_checkpoint(path)["params"]


def find_latest_checkpoint(root: str) -> Optional[str]:
    """The highest-step ``checkpoint-<N>steps`` directory under ``root``."""
    if not os.path.isdir(root):
        return None
    best, best_step = None, -1
    for name in os.listdir(root):
        m = _STEP_DIR.fullmatch(name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(root, name)
    return best


def find_last_checkpoints(root: str, n: int,
                          max_step: Optional[int] = None) -> list:
    """The ``n`` highest-step checkpoint dirs under ``root``, ascending;
    with ``max_step`` only those at or below that step."""
    if not os.path.isdir(root):
        return []
    found = []
    for name in os.listdir(root):
        m = _STEP_DIR.fullmatch(name)
        if m and (max_step is None or int(m.group(1)) <= max_step):
            found.append((int(m.group(1)), os.path.join(root, name)))
    return [p for _, p in sorted(found)[-n:]]


def checkpoint_step(path: str) -> Optional[int]:
    """Step count encoded in a ``checkpoint-<N>steps`` path, else None."""
    m = _STEP_DIR.fullmatch(os.path.basename(os.path.normpath(path)))
    return int(m.group(1)) if m else None


def average_checkpoints(paths) -> dict:
    """Uniform average of the checkpoints' params: floating tensors summed
    in float32 in the order given and divided by their count, other
    tensors taken from the last checkpoint (as the JAX package does)."""
    if not paths:
        raise ValueError("no checkpoints to average")
    acc = None
    for p in paths:
        params = restore_params_only(p)
        if acc is None:
            acc = {k: v.float() if v.is_floating_point() else v
                   for k, v in params.items()}
            continue
        if set(params) != set(acc):
            raise KeyError(f"{p} holds other params than {paths[0]}")
        for k, v in params.items():
            acc[k] = acc[k] + v.float() if v.is_floating_point() else v
    k = float(len(paths))
    return {name: v / k if v.is_floating_point() else v
            for name, v in acc.items()}
