"""Meshes over ranks or devices, and the rows of a sharded batch
(counterpart of serenade_tpu/parallel/mesh.py).

A :class:`Mesh` names axes in JAX's order (``('data', 'model')``,
``('pipe', 'data', 'model')``, ``('data', 'pipe')``, ...) over one of two
things:

* **ranks** (``devices=None``): one process a rank, launched by
  ``torchrun`` or spawned.  Each axis has a ``torch.distributed`` group
  for this rank (all of them made at once: every rank must call
  ``new_group`` for every group in the same order).  The training
  layouts (dp, ZeRO-1, tp, cp, pp, ep) run over these.
* **devices** (``devices=[...]``): one controller over a list of torch
  devices, for data-parallel inference, where each replica converts its
  own sub-batch and no collective runs.  On CUDA it refuses more devices
  than ``torch.cuda.device_count()``, as JAX's ``make_mesh`` refuses more
  than ``jax.devices()``; a list may name one device several times
  (replicas sharing it), and on the CPU ``cpu`` replicas stand in for the
  JAX tests' virtual devices.

Under data parallelism the model's batch-wide quantities cover the global
batch, as GSPMD computes them: :func:`sharded_batch` marks this rank's
rows, and the models take masked-mean denominators through
:func:`batch_sum`, the batch's longest length through :func:`batch_max`,
and their random draws (segments, flow times, noise, dropout) through
:func:`batch_draw`, which draws for the global batch from the one
generator every rank holds and keeps this rank's rows.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
import itertools
import logging
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def maybe_init_distributed() -> None:
    """Join the default process group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``,
    ``LOCAL_RANK``): NCCL with one card a rank where CUDA is up, else
    gloo.  Does nothing when the group is already up (a caller or a test
    brought its own) or when no launcher set ``WORLD_SIZE``."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend)


def world() -> Tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Named axes over ranks (``devices`` an int array) or over torch
    devices (a ``torch.device`` array)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 groups: Optional[Dict[str, object]] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self._groups = groups or {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def over_ranks(self) -> bool:
        return not isinstance(self.devices.flat[0], torch.device)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coords(self) -> Optional[Dict[str, int]]:
        """This rank's index along each axis; None where the rank is not in
        the mesh (a mesh smaller than the world leaves ranks idle)."""
        rank, _ = world()
        hit = np.argwhere(self.devices == rank)
        if not self.over_ranks or len(hit) == 0:
            return None
        return dict(zip(self.axis_names, map(int, hit[0])))

    @property
    def member(self) -> bool:
        return self.coords() is not None

    def axis_index(self, axis: str) -> int:
        coords = self.coords()
        if coords is None:
            raise RuntimeError("this rank is not in the mesh")
        return coords.get(axis, 0)

    def group(self, axis: str):
        """This rank's process group along ``axis``; None where the axis
        has one rank (every collective over it is then the identity)."""
        return self._groups.get(axis)

    def __repr__(self):
        kind = "ranks" if self.over_ranks else "devices"
        return f"Mesh({self.shape}, {kind})"


def rank_mesh(shape: Tuple[int, ...], axis_names: Sequence[str]) -> Mesh:
    """A mesh over the first prod(shape) ranks of the world, with a group
    for each line of each axis of more than one rank."""
    rank, size = world()
    need = int(np.prod(shape))
    dims = " x ".join(f"{a}={n}" for a, n in zip(axis_names, shape))
    if need > size:
        raise ValueError(
            f"mesh {dims} needs {need} ranks but the world has {size}: "
            f"launch one process a rank, e.g. torchrun --nproc-per-node "
            f"{need}")
    if need < size:
        logger.warning("mesh %s uses %d of %d ranks; %d stay idle", dims,
                       need, size, size - need)
    ranks = np.arange(need).reshape(shape)
    groups = {}
    for ax, name in enumerate(axis_names):
        if shape[ax] == 1:
            continue
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax])
        for line in lines:
            # every rank makes every group, in the same order
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = group
    return Mesh(ranks.astype(object), axis_names, groups)


def replica_devices(n: int, device) -> list:
    """``n`` devices for data-parallel inference on ``device``'s type:
    ``cuda:0`` .. ``cuda:n-1`` (refused past the visible cards), or ``n``
    replicas of ``cpu``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * n
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > visible:
        raise ValueError(f"a {n}-way data mesh needs {n} CUDA devices but "
                         f"{visible} are visible (name a device twice in "
                         f"devices= to run replicas on one card)")
    return [torch.device("cuda", i) for i in range(n)]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device()
                            if torch.cuda.is_available() else 0)
    return d


def _device_mesh(shape, axis_names, devices) -> Mesh:
    devices = [_device(d) for d in devices]
    need = int(np.prod(shape))
    if need > len(devices):
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs {need} "
                         f"devices but {len(devices)} were given")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for d in devices[:need]:
        if d.type == "cuda" and (d.index or 0) >= visible:
            raise ValueError(f"{d} is not a visible CUDA device "
                             f"({visible} visible)")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return Mesh(arr.reshape(shape), axis_names)


def make_mesh(data: int = -1, model: int = 1,
              devices: Optional[Sequence] = None,
              axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    """A 2-D mesh, the second axis innermost (a rank's ``model`` group is
    its neighbours).  ``data=-1`` takes every remaining rank or device.
    Over ranks unless ``devices`` are given."""
    n = world()[1] if devices is None else len(devices)
    if data == -1:
        if n % model:
            raise ValueError(f"{n} {'ranks' if devices is None else 'devices'}"
                             f" not divisible by {axis_names[1]}={model}")
        data = n // model
    shape = (data, model)
    if devices is None:
        return rank_mesh(shape, axis_names)
    return _device_mesh(shape, axis_names, devices)


def composed_mesh(data: int = 1, model: int = 1, pipe: int = 1,
                  devices: Optional[Sequence] = None) -> Mesh:
    """The ``('pipe', 'data', 'model')`` mesh of the composed dp × tp × pp
    step: ``model`` innermost (its all-reduce closes every stage), ``data``
    next, ``pipe`` outermost (one shift a tick)."""
    shape, names = (pipe, data, model), ("pipe", "data", "model")
    if devices is None:
        return rank_mesh(shape, names)
    return _device_mesh(shape, names, devices)


# --- data-parallel inference: replicas on a device mesh -------------------


def replicate(module: torch.nn.Module, mesh: Mesh) -> list:
    """One module for each device of ``mesh`` in order: ``module`` itself
    on its own device, a copy on another (replicas on one device share
    it)."""
    state = next(itertools.chain(module.parameters(), module.buffers()),
                 None)
    if state is None:           # no weights: every replica runs ``module``
        return [module] * mesh.size
    copies = {state.device: module}
    out = []
    for dev in mesh.devices.reshape(-1):
        if dev not in copies:
            copies[dev] = copy.deepcopy(module).to(dev)
        out.append(copies[dev])
    return out


def run_replicas(mesh: Mesh, fn, items) -> list:
    """``fn(i, item)`` for each replica ``i`` of ``mesh`` in turn, on its
    device and, on CUDA, on that device's stream for the mesh: launches
    are asynchronous, so replicas on different devices overlap though the
    host enqueues them one after another.  Replicas on one device share
    its stream, as they share its weights and the operands the kernels
    cache from them (``ops/_cuda.py`` ``VersionCache``), which one stream
    keeps ordered.  The caller's streams then wait for the replicas'."""
    devices = list(mesh.devices.reshape(-1))
    if not hasattr(mesh, "_streams"):
        mesh._streams = {d: torch.cuda.Stream(device=d) for d in devices
                         if d.type == "cuda"}
    for dev, stream in mesh._streams.items():
        stream.wait_stream(torch.cuda.current_stream(dev))
    outs = []
    for i, (dev, item) in enumerate(zip(devices, items)):
        stream = mesh._streams.get(dev)
        if stream is None:
            outs.append(fn(i, item))
            continue
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            outs.append(fn(i, item))
    for dev, stream in mesh._streams.items():
        torch.cuda.current_stream(dev).wait_stream(stream)
    return outs


def split_rows(t: torch.Tensor, n: int) -> list:
    """``t``'s leading axis in ``n`` equal parts."""
    if t.shape[0] % n:
        raise ValueError(f"batch {t.shape[0]} not divisible by the {n}-way "
                         f"data mesh; pad the batch to a multiple")
    return list(t.chunk(n))


# --- specs (PartitionSpec): one axis name or None per dimension -----------


class P(tuple):
    """A partition spec: for each dimension the mesh axis it is split
    over, or None (JAX's ``PartitionSpec``; trailing dimensions left out
    are not split)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class Sharding:
    mesh: Mesh
    spec: P


def data_sharding(mesh: Mesh) -> Sharding:
    """Arrays with a leading batch axis, split over ``data``."""
    return Sharding(mesh, P("data"))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, P())


def batch_spec(tree):
    """A spec of ``P('data')`` for every leaf of a dict tree."""
    if isinstance(tree, dict):
        return {k: batch_spec(v) for k, v in tree.items()}
    return P("data")


def _rows(n: int, parts: int, index: int) -> slice:
    if n % parts:
        raise ValueError(f"batch {n} not divisible by the {parts}-way data "
                         f"axis")
    per = n // parts
    return slice(index * per, (index + 1) * per)


def shard_batch(batch, mesh: Mesh):
    """The global batch's rows for this rank's index on ``data`` (a rank
    mesh), or one sub-batch for each device along ``data`` (a device
    mesh).  ``batch`` is a dict of arrays or tensors with a leading batch
    axis."""
    d = mesh.axis_size("data")
    if mesh.over_ranks:
        idx = mesh.axis_index("data")
        return {k: v[_rows(len(v), d, idx)] for k, v in batch.items()}
    return [{k: v[_rows(len(v), d, i)] for k, v in batch.items()}
            for i in range(d)]


# --- the rows of a batch sharded over a data group ------------------------


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's rows ``[start, stop)`` of a global batch of ``total``,
    with the ``group`` of the ranks that hold the other rows."""
    group: object
    start: int
    stop: int
    total: int


_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "serenade_batch_shard", default=None)


def batch_shard(mesh: Mesh, local_rows: int,
                axis: str = "data") -> Optional[BatchShard]:
    """The shard of this rank's ``local_rows`` along ``axis`` (None where
    the axis has one rank)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return None
    i = mesh.axis_index(axis)
    return BatchShard(mesh.group(axis), i * local_rows,
                      (i + 1) * local_rows, n * local_rows)


def current_shard() -> Optional[BatchShard]:
    return _SHARD.get()


@contextlib.contextmanager
def sharded_batch(shard: Optional[BatchShard]):
    """Within the block the model's batch-wide sums, maxima and draws
    cover the global batch of which this rank holds ``shard``'s rows."""
    token = _SHARD.set(shard)
    try:
        yield
    finally:
        _SHARD.reset(token)


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a sum over this rank's rows, no gradient) summed over the
    global batch."""
    shard = _SHARD.get()
    if shard is None:
        return t
    from serenade_tpu_torch.parallel.comm import all_reduce_

    return all_reduce_(t.detach().clone(), shard.group)


def batch_max(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a maximum over this rank's rows) over the global batch."""
    shard = _SHARD.get()
    if shard is None:
        return t
    from serenade_tpu_torch.parallel.comm import all_reduce_

    return all_reduce_(t.detach().clone(), shard.group, op="max")


def batch_draw(draw, shape, **kwargs) -> torch.Tensor:
    """``draw(shape, **kwargs)`` (``torch.rand``, ``torch.randn``) with a
    leading batch axis: drawn for the global batch and cut to this rank's
    rows under :func:`sharded_batch`, so every rank's generator moves as
    the single-process run's does."""
    shard = _SHARD.get()
    if shard is None:
        return draw(tuple(shape), **kwargs)
    full = draw((shard.total,) + tuple(shape[1:]), **kwargs)
    return full[shard.start:shard.stop]
