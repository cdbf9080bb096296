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

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from serenade_tpu_torch import resolve_device
from serenade_tpu_torch.schedulers import SCHEDULERS

METRICS = ("train/vector_loss", "train/prior_loss", "train/loss")


@dataclasses.dataclass
class TrainState:
    params: Dict[str, nn.Parameter]   # the model's own, updated in place
    opt_state: Dict[str, Any]
    step: int = 0


def _f32_power(base: float, count: int) -> float:
    """``base ** count`` rounded as optax's f32 bias correction rounds it."""
    return float(np.float32(base) ** np.float32(count))


class Optimizer:
    """``optax.chain(clip_by_global_norm, adamw | adam | sgd)`` with a
    schedule, over a list of tensors."""

    def __init__(self, kind: str, schedule: Callable[[int], float], *,
                 grad_norm: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype=None,
                 momentum: Optional[float] = None):
        if kind not in ("AdamW", "Adam", "SGD"):
            raise ValueError(f"unknown optimizer '{kind}'")
        self.kind, self.schedule = kind, schedule
        self.grad_norm = float(grad_norm) if grad_norm else None
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay if kind == "AdamW" else 0.0
        self.mu_dtype = (getattr(torch, mu_dtype) if isinstance(mu_dtype, str)
                         else mu_dtype)
        self.momentum = momentum or None

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        state: Dict[str, Any] = {"count": 0}
        if self.kind == "SGD":
            if self.momentum:
                state["trace"] = [torch.zeros_like(p) for p in params]
        else:
            state["mu"] = [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                           for p in params]
            state["nu"] = [torch.zeros_like(p) for p in params]
        return state

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict[str, Any]) -> torch.Tensor:
        """Apply one update to ``params`` in place; returns the global norm
        of ``grads`` before clipping."""
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        g = grads
        if self.grad_norm is not None:
            # optax's select, kept on the device: t when ‖g‖ < max_norm,
            # else (t / ‖g‖) · max_norm (t / 1 · 1 is t exactly)
            keep = norm < self.grad_norm
            one = torch.ones_like(norm)
            g = torch._foreach_div(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(g, torch.where(
                keep, one, torch.full_like(norm, self.grad_norm)))
        count = state["count"]
        lr = self.schedule(count)
        if self.kind == "SGD":
            if self.momentum:
                torch._foreach_mul_(state["trace"], self.momentum)
                torch._foreach_add_(state["trace"], g)
                g = state["trace"]
            upd = torch._foreach_mul(g, -lr)
        else:
            b1, b2, c = self.b1, self.b2, count + 1
            # JAX's promotion: b1 is rounded to mu's dtype and b1·mu rounds
            # there; the sum with (1 - b1)·g is f32
            b1_mu = torch.tensor(b1, dtype=self.mu_dtype or torch.float32)
            mu = [m.float() for m in
                  torch._foreach_mul(state["mu"], b1_mu.item())]
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
            nu = state["nu"]
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
            if self.mu_dtype is not None:
                mu = [m.to(self.mu_dtype) for m in mu]
            state["mu"] = mu
        torch._foreach_add_(params, upd)
        state["count"] = count + 1
        return norm


def build_optimizer(config: Mapping[str, Any]):
    """(Optimizer, schedule) from a recipe-style config (``optimizer_type``,
    ``optimizer_params`` with ``lr``, ``scheduler_type``,
    ``scheduler_params``, ``grad_norm``), as
    ``serenade_tpu.trainers.build_optimizer`` reads it.  AdamW's weight
    decay defaults to 0.01, as there."""
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
                    **{k: v for k, v in opt_params.items() if k in keys})
    return opt, schedule


def create_train_state(model: nn.Module, opt: Optimizer) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(params=params,
                      opt_state=opt.init(list(params.values())), step=0)


def build_train_step(model: nn.Module, opt: Optimizer, *,
                     prior_loss_start_steps: int = 0, grad_accum: int = 1,
                     device=None):
    """``(state, batch, generator, draws=None) -> (state, metrics)`` for a
    ``state`` from ``create_train_state(model, opt)``.

    ``batch`` holds ``x``, ``lengths``, ``logmel``, ``midi`` and ``loud``
    with a leading batch axis, or ``(grad_accum, micro_batch, ...)`` when
    ``grad_accum > 1``; the gradients and metrics are the means over the
    micro-batches.  ``generator`` (on the device) draws the segments, flow
    times, noise and dropout masks; ``draws`` (one dict per micro-batch,
    see ``Serenade.forward``) replaces them.  The prior loss joins the
    loss once ``step > prior_loss_start_steps``.  Metrics:
    ``train/vector_loss``, ``train/prior_loss``, ``train/loss`` and
    ``train/grad_norm`` (before clipping), as 0-d tensors.  Runs on CUDA
    unless ``device`` says otherwise.
    """
    dev = resolve_device(device)
    bad = [n for n, p in model.named_parameters()
           if p.device.type != dev.type]
    if bad:
        raise ValueError(f"parameters not on {dev}: {bad[:3]}")

    def micro(batch, generator, draws, step):
        out = model(batch["x"], batch["lengths"], batch["logmel"],
                    batch["midi"], batch["loud"], generator=generator,
                    draws=draws)
        use_prior = float(step > prior_loss_start_steps)
        loss = out["cfm_loss"] + use_prior * out["prior_loss"]
        loss.backward()
        return torch.stack([out["cfm_loss"], out["prior_loss"],
                            loss]).detach()

    def step_fn(state: TrainState, batch: Mapping[str, Any],
                generator: Optional[torch.Generator] = None,
                draws=None):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        params = list(state.params.values())
        for p in params:
            p.grad = None
        if grad_accum > 1:
            draws = draws or [None] * grad_accum
            sums = sum(micro({k: v[i] for k, v in batch.items()}, generator,
                             draws[i], state.step)
                       for i in range(grad_accum))
            values = sums * (1.0 / grad_accum)
        else:
            values = micro(batch, generator, draws, state.step)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if grad_accum > 1:
            torch._foreach_mul_(grads, 1.0 / grad_accum)
        metrics = dict(zip(METRICS, values))
        metrics["train/grad_norm"] = opt.update(params, grads,
                                                state.opt_state)
        state.step += 1
        return state, metrics

    return step_fn
