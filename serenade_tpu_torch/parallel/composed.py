"""Composed dp × tp × pp: tensor-parallel pipeline stages (counterpart of
serenade_tpu/parallel/composed.py).

One step on a ``('pipe', 'data', 'model')`` rank mesh
(``mesh.composed_mesh``): :func:`~serenade_tpu_torch.parallel.pipeline.
gpipe` streams microbatches over ``pipe`` with the microbatch rows split
over ``data``, and each stage is a pre-norm GEGLU feed-forward block (the
UNet transformer's FFN: GEGLU and an output projection) whose weights are
split Megatron's way over ``model``: the value and gate kernels by
columns, the output projection by rows, closed by *g*
(``comm.reduce_from_group``), with *f* (``comm.copy_to_group``) on the
stage's input so that its gradient sums the column shards'.  The
gradients of the weights, which every ``data`` rank holds whole, are
summed over ``data``; Adam is the port's optimizer.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import torch

from serenade_tpu_torch.parallel import comm
from serenade_tpu_torch.parallel.mesh import Mesh, P
from serenade_tpu_torch.parallel.pipeline import StageShard, gpipe


def init_ffn_stages(generator: torch.Generator, n_stages: int, d: int,
                    inner: int) -> List[Dict[str, torch.Tensor]]:
    """Full per-stage parameters: pre-norm gain ``g`` ``(d,)``, GEGLU value
    and gate kernels ``(d, inner)``, output projection ``(inner, d)``
    (flax's ``(in, out)`` layout)."""
    stages = []
    for _ in range(n_stages):
        stages.append({
            "g": torch.ones(d),
            "wv": torch.randn(d, inner, generator=generator) / d ** 0.5,
            "wg": torch.randn(d, inner, generator=generator) / d ** 0.5,
            "wo": torch.randn(inner, d, generator=generator) / inner ** 0.5,
        })
    return stages


def stage_param_specs() -> Dict[str, P]:
    """Specs of the stacked stage parameters (leading ``pipe`` axis): the
    GEGLU kernels split by columns, the output projection by rows, the
    gain whole on every ``model`` rank."""
    return {"g": P("pipe"), "wv": P("pipe", None, "model"),
            "wg": P("pipe", None, "model"), "wo": P("pipe", "model", None)}


def place_composed_params(stacked: Dict[str, torch.Tensor],
                          mesh: Mesh) -> StageShard:
    """This rank's stage (leading axis 1) and its ``model`` shard of each
    split kernel."""
    s, idx = mesh.axis_size("pipe"), mesh.axis_index("pipe")
    m, mi = mesh.axis_size("model"), mesh.axis_index("model")
    out = {}
    for k, spec in stage_param_specs().items():
        leaf = stacked[k][idx:idx + 1]
        if "model" in spec:
            leaf = comm.shard_of(leaf, list(spec).index("model"), m, mi)
        out[k] = leaf.clone()
    return StageShard(out, s)


def _prenorm(x, g):
    h = x - x.mean(dim=-1, keepdim=True)
    h = h * torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + 1e-6)
    return h * g


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def ffn_stage_tp(p, a, model_group=None):
    """One stage on this rank's ``model`` shards: *f* on the normed input,
    the column-split GEGLU, the row-split projection closed by *g*, so the
    activations stay whole between stages."""
    h = comm.copy_to_group(_prenorm(a, p["g"]), model_group)
    y = (h @ p["wv"]) * _gelu(h @ p["wg"])
    return a + comm.reduce_from_group(y @ p["wo"], model_group)


def ffn_stage_full(p, a):
    """One stage on the full weights (the one-rank reference)."""
    h = _prenorm(a, p["g"])
    y = (h @ p["wv"]) * _gelu(h @ p["wg"])
    return a + y @ p["wo"]


def build_composed_step(mesh: Mesh, lr: float = 1e-2):
    """A train step through the composed pipeline: ``(opt, step_fn)`` with
    ``step_fn(stage, opt_state, xmb, target) -> loss``, which updates
    ``stage`` (from :func:`place_composed_params`, leaves requiring grad)
    and ``opt_state`` (``opt.init(stage)``) in place; ``xmb`` and
    ``target`` are the whole ``(M, mb, ...)`` microbatched batch on every
    rank, and the loss is the global mean squared error."""
    from serenade_tpu_torch.trainers.train_step import Optimizer

    opt = Optimizer("Adam", lambda count: lr)
    stage_fn = functools.partial(ffn_stage_tp,
                                 model_group=mesh.group("model"))
    dgroup = mesh.group("data")

    def step_fn(stage, opt_state, xmb, target):
        for v in stage.values():
            v.grad = None
        y = gpipe(stage_fn, stage, xmb, mesh, data_axis="data")
        loss = torch.mean((y - target) ** 2)
        loss.backward()
        # each data rank's gradient is its rows' share of the global mean
        grads = {k: comm.all_reduce_(v.grad, dgroup)
                 for k, v in stage.items()}
        opt.update(stage, grads, opt_state)
        return loss.detach()

    return opt, step_fn
