"""One training step: loss → backward → global-norm clip → optimizer
(counterpart of serenade_tpu/trainers/train_step.py).

The optimizers follow optax's chains, not ``torch.optim``:

- ``clip_by_global_norm``: scale by ``max_norm / ‖g‖`` only when
  ``‖g‖ >= max_norm`` (computed as ``(g / ‖g‖) * max_norm``);
- ``adamw`` / ``adam`` (``scale_by_adam``): the update uses the f32 first
  moment before it is stored in ``mu_dtype``; ``m̂ / (√v̂ + eps)``;
  decoupled weight decay ``wd·p`` is added before the learning-rate scale;
- ``sgd`` with an optional momentum trace;
- the rate of update k (counting from 0) is ``schedule(k)``.

Where JAX returns a new state, the port updates the model's f32 master
weights and the moments in place.  The moment updates run as
``torch._foreach_*`` operations, a few launches for all parameters.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from serenade_tpu_torch import resolve_device
from serenade_tpu_torch.parallel.mesh import sharded_batch
from serenade_tpu_torch.schedulers import SCHEDULERS

METRICS = ("train/vector_loss", "train/prior_loss", "train/loss")


@dataclasses.dataclass
class TrainState:
    params: Dict[str, nn.Parameter]   # the model's own, updated in place
    opt_state: Dict[str, Any]
    step: int = 0
    # the dp / tp / ZeRO-1 layout (parallel.sharding.ParallelLayout), or
    # None on one card
    layout: Any = None


def _f32_power(base: float, count: int) -> float:
    """``base ** count`` rounded as optax's f32 bias correction rounds it."""
    return float(np.float32(base) ** np.float32(count))


# the optimizer kinds a config's ``optimizer_type`` names (the JAX
# package's registered optimizers)
OPTIMIZERS = ("AdamW", "Adam", "SGD")


class Optimizer:
    """``optax.chain(clip_by_global_norm, adamw | adam | sgd)`` with a
    schedule, over named tensors.

    ``trainable_mask`` (name -> bool, ``utils.model_io.freeze_mask``) is
    ``optax.multi_transform({True: chain, False: set_to_zero})``: the clip's
    global norm counts the trainable gradients only, and frozen tensors
    never move and hold no moments.  The state is keyed by name
    (``{"count", "mu", "nu"}`` or ``{"count", "trace"}``), so a checkpoint
    restore can check it against the live one."""

    def __init__(self, kind: str, schedule: Callable[[int], float], *,
                 grad_norm: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype=None,
                 momentum: Optional[float] = None,
                 trainable_mask: Optional[Mapping[str, bool]] = None):
        if kind not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer '{kind}'")
        self.kind, self.schedule = kind, schedule
        self.grad_norm = float(grad_norm) if grad_norm else None
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay if kind == "AdamW" else 0.0
        self.mu_dtype = (getattr(torch, mu_dtype) if isinstance(mu_dtype, str)
                         else mu_dtype)
        self.momentum = momentum or None
        self.trainable_mask = (None if trainable_mask is None
                               else dict(trainable_mask))

    def trainable(self, params: Mapping[str, torch.Tensor]) -> List[str]:
        """The names of ``params`` the optimizer moves."""
        names = list(params)
        if self.trainable_mask is None:
            return names
        unknown = set(names) ^ set(self.trainable_mask)
        if unknown:
            raise KeyError(f"trainable_mask and the parameters differ at "
                           f"{sorted(map(str, unknown))[:5]}")
        return [n for n in names if self.trainable_mask[n]]

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        """The state for ``params`` (name -> tensor)."""
        train = {n: params[n] for n in self.trainable(params)}
        state: Dict[str, Any] = {"count": 0}
        if self.kind == "SGD":
            if self.momentum:
                state["trace"] = {n: torch.zeros_like(p)
                                  for n, p in train.items()}
        else:
            state["mu"] = {n: torch.zeros_like(
                p, dtype=self.mu_dtype or p.dtype) for n, p in train.items()}
            state["nu"] = {n: torch.zeros_like(p) for n, p in train.items()}
        return state

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor],
               state: Dict[str, Any], *,
               norms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
        """Apply one update to ``params`` in place (``grads`` keyed as
        ``params``); returns the global norm of all ``grads`` before
        clipping.  ``norms`` (the global norms of all gradients and of the
        trainable ones) stand in for the norms of ``grads`` where those
        are shards (``parallel.sharding.ParallelLayout.update``)."""
        if norms is None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(list(grads.values()))))
        else:
            norm = norms[0]
        names = self.trainable(params)
        if not names:                   # everything frozen: nothing moves
            state["count"] += 1
            return norm
        params = [params[n] for n in names]
        grads = [grads[n] for n in names]
        g = grads
        if self.grad_norm is not None:
            # the trainable gradients' norm (all of them when none is frozen)
            tnorm = (torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads))) if norms is None
                else norms[1])
            # optax's select, kept on the device: t when ‖g‖ < max_norm,
            # else (t / ‖g‖) · max_norm (t / 1 · 1 is t exactly)
            keep = tnorm < self.grad_norm
            one = torch.ones_like(tnorm)
            g = torch._foreach_div(grads, torch.where(keep, one, tnorm))
            torch._foreach_mul_(g, torch.where(
                keep, one, torch.full_like(tnorm, self.grad_norm)))
        count = state["count"]
        lr = self.schedule(count)
        if self.kind == "SGD":
            if self.momentum:
                trace = [state["trace"][n] for n in names]
                torch._foreach_mul_(trace, self.momentum)
                torch._foreach_add_(trace, g)
                g = trace
            upd = torch._foreach_mul(g, -lr)
        else:
            b1, b2, c = self.b1, self.b2, count + 1
            # JAX's promotion: b1 is rounded to mu's dtype and b1·mu rounds
            # there; the sum with (1 - b1)·g is f32
            b1_mu = torch.tensor(b1, dtype=self.mu_dtype or torch.float32)
            mu = [m.float() for m in torch._foreach_mul(
                [state["mu"][n] for n in names], b1_mu.item())]
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
            nu = [state["nu"][n] for n in names]
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
            den = torch._foreach_div(nu, 1.0 - _f32_power(b2, c))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(mu, 1.0 - _f32_power(b1, c))
            torch._foreach_div_(upd, den)
            if self.weight_decay:
                torch._foreach_add_(upd, params, alpha=self.weight_decay)
            torch._foreach_mul_(upd, -lr)
            # the stored moments in mu_dtype, written in place
            torch._foreach_copy_([state["mu"][n] for n in names], mu)
        torch._foreach_add_(params, upd)
        state["count"] = count + 1
        return norm


def build_optimizer(config: Mapping[str, Any],
                    trainable_mask: Optional[Mapping[str, bool]] = None):
    """(Optimizer, schedule) from a recipe-style config (``optimizer_type``,
    ``optimizer_params`` with ``lr``, ``scheduler_type``,
    ``scheduler_params``, ``grad_norm``), as
    ``serenade_tpu.trainers.build_optimizer`` reads it.  AdamW's weight
    decay defaults to 0.01, as there.  ``trainable_mask``: parameter name
    -> trainable (``utils.model_io.freeze_mask``)."""
    opt_params = dict(config.get("optimizer_params", {}))
    lr = opt_params.pop("lr", 1e-3)
    schedule = SCHEDULERS[config.get("scheduler_type", "ConstantLR")](
        lr, **config.get("scheduler_params", {}))
    kind = config.get("optimizer_type", "AdamW")
    if kind == "AdamW":
        opt_params.setdefault("weight_decay", 0.01)
    keys = {"AdamW": ("b1", "b2", "eps", "weight_decay", "mu_dtype"),
            "Adam": ("b1", "b2", "eps", "mu_dtype"),
            "SGD": ("momentum",)}.get(kind, ())
    opt = Optimizer(kind, schedule, grad_norm=config.get("grad_norm"),
                    trainable_mask=trainable_mask,
                    **{k: v for k, v in opt_params.items() if k in keys})
    return opt, schedule


def create_train_state(model: nn.Module, opt: Optimizer,
                       layout=None) -> TrainState:
    """The state of ``model``'s parameters; under a ``layout``
    (``parallel.sharding.shard_params``, applied to ``model`` already) the
    tp leaves are this rank's shards and the ZeRO-1 moments take their
    shards' shapes."""
    params = dict(model.named_parameters())
    opt_state = (opt.init(params) if layout is None
                 else layout.init_opt_state(opt, params))
    return TrainState(params=params, opt_state=opt_state, step=0,
                      layout=layout)


def local_draws(draws, shard):
    """``draws`` for the global batch cut to ``shard``'s rows: the entries
    with a leading batch axis (``t``, ``z``, ``x0``); the segment's
    scalars stay."""
    if not draws or shard is None:
        return draws
    return {k: v[shard.start:shard.stop]
            if torch.is_tensor(v) and v.dim() and v.shape[0] == shard.total
            else v for k, v in draws.items()}


def apply_update(opt: Optimizer, state: TrainState,
                 grads: List[torch.Tensor]) -> torch.Tensor:
    """The optimizer's update of ``state`` from this rank's gradients (in
    ``state.params``' order), through its layout where it has one;
    returns the global gradient norm."""
    named = dict(zip(state.params, grads))
    if state.layout is None:
        return opt.update(state.params, named, state.opt_state)
    return state.layout.update(opt, state.params, named, state.opt_state)


def to_device(v, dev: torch.device) -> torch.Tensor:
    """A batch array on ``dev``; a host array goes up through pinned
    memory without blocking (a pageable copy waits for the stream)."""
    t = torch.as_tensor(v)
    if t.device.type == dev.type:
        return t
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def build_train_step(model: nn.Module, opt: Optimizer, *,
                     prior_loss_start_steps: int = 0, grad_accum: int = 1,
                     device=None):
    """``(state, batch, generator, draws=None) -> (state, metrics)`` for a
    ``state`` from ``create_train_state(model, opt)``.

    ``batch`` holds ``x``, ``lengths``, ``logmel``, ``midi`` and ``loud``
    (and ``f0_fluc`` for the F0-fluctuation variant) with a leading batch
    axis, or ``(grad_accum, micro_batch, ...)`` when
    ``grad_accum > 1``; the gradients and metrics are the means over the
    micro-batches.  ``generator`` (on the device) draws the segments, flow
    times, noise and dropout masks; ``draws`` (one dict per micro-batch,
    see ``Serenade.forward``) replaces them.  The prior loss joins the
    loss once ``step > prior_loss_start_steps``.  Metrics:
    ``train/vector_loss``, ``train/prior_loss``, ``train/loss`` and
    ``train/grad_norm`` (before clipping), as 0-d tensors.  Runs on CUDA
    unless ``device`` says otherwise.

    Under the state's ``layout`` (dp, tp, ZeRO-1 over a rank mesh) every
    rank calls the step with its rows of the global batch
    (``parallel.shard_batch``) and the same ``generator`` state, or with
    ``draws`` for the global batch; the draws, the masked means and the
    segment then cover the global batch, the gradients and losses are
    summed over the ``data`` group, and the metrics are the global
    batch's on every rank.
    """
    dev = resolve_device(device)
    bad = [n for n, p in model.named_parameters()
           if p.device.type != dev.type]
    if bad:
        raise ValueError(f"parameters not on {dev}: {bad[:3]}")

    def micro(batch, generator, draws, step):
        # the variant's F0 fluctuation, where the batch has it
        extra = {"f0_fluc": batch["f0_fluc"]} if "f0_fluc" in batch else {}
        out = model(batch["x"], batch["lengths"], batch["logmel"],
                    batch["midi"], batch["loud"], generator=generator,
                    draws=draws, **extra)
        use_prior = float(step > prior_loss_start_steps)
        loss = out["cfm_loss"] + use_prior * out["prior_loss"]
        loss.backward()
        return torch.stack([out["cfm_loss"], out["prior_loss"],
                            loss]).detach()

    def step_fn(state: TrainState, batch: Mapping[str, Any],
                generator: Optional[torch.Generator] = None,
                draws=None):
        batch = {k: to_device(v, dev) for k, v in batch.items()}
        params = list(state.params.values())
        for p in params:
            p.grad = None
        layout = state.layout
        rows = batch["x"].shape[1 if grad_accum > 1 else 0]
        shard = None if layout is None else layout.batch_shard(rows)
        with contextlib.ExitStack() as scope:
            if layout is not None:
                scope.enter_context(layout.materialized())
            scope.enter_context(sharded_batch(shard))
            if grad_accum > 1:
                draws = draws or [None] * grad_accum
                sums = sum(micro({k: v[i] for k, v in batch.items()},
                                 generator, local_draws(draws[i], shard),
                                 state.step)
                           for i in range(grad_accum))
                values = sums * (1.0 / grad_accum)
            else:
                values = micro(batch, generator, local_draws(draws, shard),
                               state.step)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if grad_accum > 1:
            torch._foreach_mul_(grads, 1.0 / grad_accum)
        if layout is not None:
            values = layout.reduce_metrics(values)
        metrics = dict(zip(METRICS, values))
        metrics["train/grad_norm"] = apply_update(opt, state, grads)
        state.step += 1
        return state, metrics

    return step_fn
