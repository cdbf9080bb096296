"""Checkpoint save/restore (counterpart of serenade_tpu/checkpoint.py).

The same step-named directories as the JAX package,
``<root>/checkpoint-<steps>steps``, found by step number.  Each holds one
``torch.save`` file, ``checkpoint.pt``: ``{"params": <state dict of the
port's model>, "opt_state": <the optimizer's state, keyed by parameter
name (trainers.train_step.Optimizer)>, "meta": {"step", "epochs", and
what the caller adds}}`` (a vocoder checkpoint holds ``{"generator",
"discriminator"}`` state dicts under each of ``params`` and
``opt_state``, and its segment sampler's state under ``meta``),
written synchronously or by :class:`AsyncSaver`.  An Orbax
directory written by the JAX package cannot be read without JAX: it is
refused by name, and its params cross through the param bridge
(``serenade_tpu_torch.convert``) instead.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Optional

import torch

CHECKPOINT_FILE = "checkpoint.pt"
_STEP_DIR = re.compile(r"checkpoint-(\d+)steps")
# files Orbax writes at the top of a checkpoint directory
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"checkpoint-{step}steps")


def _ckpt_state(step: int, params, opt_state, epochs: int,
                meta: Optional[dict] = None) -> dict:
    state = {"params": dict(params)}
    if opt_state is not None:
        state["opt_state"] = opt_state
    state["meta"] = dict(meta or {}, step=int(step), epochs=int(epochs))
    return state


def _write(path: str, state: dict) -> None:
    """``state`` into ``path``/checkpoint.pt, through a ``.tmp`` file
    renamed into place (a reader never sees a partial file)."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))


def save_checkpoint(root: str, step: int, params, opt_state=None,
                    epochs: int = 0) -> str:
    """Write ``params`` (a state dict) and ``opt_state`` under
    ``<root>/checkpoint-<step>steps``; returns that directory."""
    path = _ckpt_dir(root, step)
    _write(path, _ckpt_state(step, params, opt_state, epochs))
    return path


def _map_tensors(tree, fn):
    """``tree`` (nested dicts) with ``fn`` applied to every tensor."""
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return fn(tree) if torch.is_tensor(tree) else tree


class AsyncSaver:
    """Checkpoint saves that do not stall the step loop for the write.

    ``save`` snapshots the state first: CUDA tensors are copied into
    pinned host memory on a side stream that waits for the work queued
    so far, and the current stream then waits for those copies, so the
    next step's in-place updates of the parameters and moments run only
    after the snapshot holds the state as it was (CPU tensors are cloned
    on the spot).  A background thread then waits for the copies and
    writes the file (``.tmp``, then renamed).  A save issued while the
    previous one is still writing waits for it first.  :meth:`wait`
    blocks until the last save is on disk and raises its error, if any;
    :meth:`close` does the same at shutdown."""

    def __init__(self):
        self._thread = None
        self._error = None
        self._streams = {}

    def _snapshot(self, state):
        devices = set()
        _map_tensors(state, lambda t: devices.add(t.device))
        cuda = next((d for d in devices if d.type == "cuda"), None)
        if cuda is None:
            return _map_tensors(state, lambda t: t.detach().clone()), None
        side = self._streams.get(cuda)
        if side is None:
            side = self._streams[cuda] = torch.cuda.Stream(device=cuda)
        current = torch.cuda.current_stream(cuda)
        side.wait_stream(current)

        def to_host(t):
            if t.device.type != "cuda":
                return t.detach().clone()
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t.detach(), non_blocking=True)

        with torch.cuda.stream(side):
            snap = _map_tensors(state, to_host)
            done = torch.cuda.Event()
            done.record(side)
        current.wait_event(done)
        return snap, done

    def _commit(self, path, snap, done):
        try:
            if done is not None:
                done.synchronize()
            _write(path, snap)
        except BaseException as exc:  # noqa: BLE001 — raised by wait()
            self._error = exc

    def save(self, root: str, step: int, params, opt_state=None,
             epochs: int = 0, meta: Optional[dict] = None) -> str:
        """Start saving ``params``, ``opt_state`` and the entries of
        ``meta`` under ``<root>/checkpoint-<step>steps``; returns that
        directory."""
        self.wait()
        path = _ckpt_dir(root, step)
        snap, done = self._snapshot(
            _ckpt_state(step, params, opt_state, epochs, meta))
        self._thread = threading.Thread(target=self._commit,
                                        args=(path, snap, done),
                                        name="ckpt-commit")
        self._thread.start()
        return path

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def close(self):
        self.wait()


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


def restore_generator_params(path: str) -> dict:
    """The generator's state dict of a vocoder checkpoint of
    ``bin/vocoder_train.py``, whose ``params`` hold ``{"generator",
    "discriminator"}`` (the JAX trainer's layout)."""
    params = restore_checkpoint(path)["params"]
    if "generator" not in params:
        raise KeyError(f"{path} is not a vocoder checkpoint (no generator "
                       "under its params)")
    return params["generator"]


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
