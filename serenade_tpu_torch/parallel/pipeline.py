"""Pipeline parallelism: GPipe microbatching over a ``pipe`` rank axis
(counterpart of serenade_tpu/parallel/pipeline.py).

A uniform stack of S stages runs one stage a rank along the ``pipe`` axis
and M microbatches stream through it in ``M + S - 1`` ticks: at each tick
stage 0 takes microbatch ``t`` and every stage hands its output to the
next with a ring shift (``comm.ring_shift``, the counterpart of
``lax.ppermute``).  The last stage's outputs reach every rank through
Megatron's *g* (``comm.reduce_from_group``), and autograd through the
ticks gives the pipeline's backward, the shifts running in reverse.

As in JAX's ``shard_map`` program, every tick's output stays in the
autograd graph (``torch.where`` selects what is collected), so every
rank runs the same shifts backward in the same order, and a discarded
warm-up output gets a zero gradient.  Warm-up ticks therefore run on real
data (the first microbatch), not zeros: a stage with an unbounded
derivative at 0 (``sqrt``) would turn that zero into NaN.

Layout: the full stack (leaves with a leading stage axis of S, from
:func:`stack_stage_params`) or this rank's stage of it
(:func:`place_pipeline_params`, the memory point of pp); ``x`` is the
whole ``(M, mb, ...)`` microbatched input on every rank, and the output
has its shape.  ``data_axis`` composes dp × pp: each pipeline instance
runs its rows of every microbatch, and the rows are gathered back.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch

from serenade_tpu_torch.parallel import comm
from serenade_tpu_torch.parallel.mesh import Mesh, make_mesh


class StageShard(dict):
    """This rank's stage of a stacked tree (leaves with a leading axis of
    1), and how many stages the whole stack has."""

    def __init__(self, leaves: Mapping[str, torch.Tensor], stages: int):
        super().__init__(leaves)
        self.stages = stages


def stack_stage_params(params_list) -> Dict[str, torch.Tensor]:
    """S per-stage dicts of tensors -> one dict with a leading stage
    axis."""
    return {k: torch.stack([p[k] for p in params_list])
            for k in params_list[0]}


def microbatch(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """(B, ...) -> (M, B // M, ...)."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by M={num_microbatches}")
    return x.reshape((num_microbatches, b // num_microbatches)
                     + tuple(x.shape[1:]))


def _local_stage(stacked, s: int, idx: int, axis: str):
    """This rank's stage of ``stacked``; the stage count must be the axis
    size exactly (a larger multiple would run only every (S/s)-th
    stage)."""
    if isinstance(stacked, StageShard):
        if stacked.stages != s:
            raise ValueError(f"stacked stage axis {stacked.stages} != mesh "
                             f"'{axis}' size {s}")
        return {k: v[0] for k, v in stacked.items()}
    for name, leaf in stacked.items():
        if leaf.shape[0] != s:
            raise ValueError(f"stacked stage axis {leaf.shape[0]} != mesh "
                             f"'{axis}' size {s} at {name}")
    return {k: v[idx] for k, v in stacked.items()}


def gpipe(stage_fn: Callable, stacked_params, x: torch.Tensor, mesh: Mesh,
          axis: str = "pipe", data_axis=None) -> torch.Tensor:
    """Run ``stage_fn(params, activation)`` S times (one stage a rank on
    ``axis``) over the microbatched ``x`` ``(M, mb, ...)``; returns the
    same shape on every rank, differentiable in the stage parameters and
    in ``x``.  ``data_axis`` shards the microbatch rows over that axis."""
    s = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    group = mesh.group(axis)
    p_local = _local_stage(stacked_params, s, idx, axis)
    dgroup = None
    if data_axis is not None:
        dgroup = mesh.group(data_axis)
        x = comm.shard_of(x, 1, mesh.axis_size(data_axis),
                          mesh.axis_index(data_axis))
    m = x.shape[0]
    first = torch.tensor(idx == 0, device=x.device)
    act = x[0]                  # warm-up on real data, not zeros
    outbuf = [torch.zeros_like(x[0]) for _ in range(m)]
    ticks = m + s - 1
    for t in range(ticks):
        a_in = torch.where(first, x[min(t, m - 1)], act)
        out = stage_fn(p_local, a_in)
        # the last stage's tick-t output is microbatch t - (S - 1)
        j = t - (s - 1)
        slot = min(max(j, 0), m - 1)
        valid = torch.tensor(idx == s - 1 and 0 <= j < m, device=x.device)
        outbuf[slot] = torch.where(valid, out, outbuf[slot])
        if t < ticks - 1:
            act = comm.ring_shift(out, group, 1)
    y = torch.stack(outbuf)
    # only the last stage holds real outputs; g broadcasts them
    y = torch.where(torch.tensor(idx == s - 1, device=x.device), y,
                    torch.zeros_like(y))
    y = comm.reduce_from_group(y, group)
    return comm.gather_from_group(y, dgroup, dim=1)


def place_pipeline_params(stacked: Mapping[str, torch.Tensor], mesh: Mesh,
                          axis: str = "pipe") -> StageShard:
    """This rank's stage of a stacked tree: each rank holds only its
    stage's weights, the memory point of pp."""
    s = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    n = {leaf.shape[0] for leaf in stacked.values()}
    if n != {s}:
        raise ValueError(f"stacked stage axis {sorted(n)} != mesh '{axis}' "
                         f"size {s}")
    return StageShard({k: v[idx:idx + 1].clone() for k, v in stacked.items()},
                      s)


def pipeline_mesh(pipe: int, data: int = 1) -> Mesh:
    """A ``('data', 'pipe')`` rank mesh."""
    return make_mesh(data=data, model=pipe, axis_names=("data", "pipe"))
