"""Few-step distillation of a trained CFM: Euler-10 → 1-2 steps
(counterpart of serenade_tpu/trainers/distill.py).

Each step the frozen teacher makes (x0, endpoint) pairs with
``Serenade.make_reflow_batch``: training-style infilling conditioning with
the segment fraction widened to (lo, 1.0), and its own ODE integrated
from a known temperature-scaled noise ``x0``.  Two modes:

* ``endpoint`` (default): the student's own ``k``-step Euler rollout from
  ``x0`` (``CFM.rollout``, autograd through the k estimator evaluations)
  is regressed onto the teacher's endpoint by a masked MSE.  The student
  is specialised to its k.
* ``reflow`` (rectified flow): the CFM loss with the flow source pinned to
  ``x0`` and the target to the endpoint (``CFM.compute_loss(x0=)``), which
  straightens the field at every step count.

Gradient → clip → optimizer touch the ``cfm_decoder`` tensors only: the
encoder and the GST are frozen (``distill_trainable_mask``), so the
distilled checkpoint is a drop-in for decode and serving.  The step has
``trainers.build_train_step``'s contract, so ``SSCTrainer`` drives it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from serenade_tpu_torch import resolve_device
from serenade_tpu_torch.parallel.mesh import batch_sum, sharded_batch
from serenade_tpu_torch.trainers.train_step import (
    TrainState, apply_update, local_draws, to_device,
)

METRICS = ("train/distill_loss", "train/loss")


def distill_trainable_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> trainable: the ``cfm_decoder`` tensors are, the
    encoder's and the GST's are frozen (so AdamW's weight decay cannot
    erode the weights the teacher's conditioning shares)."""
    from serenade_tpu_torch.utils.model_io import freeze_mask

    return freeze_mask(model, ["params/encoder", "params/gst"])


def frozen_teacher(model: nn.Module) -> nn.Module:
    """``model`` as a teacher: eval mode, no parameter requires grad."""
    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)
    return model


def _batch_args(batch: Mapping[str, torch.Tensor]):
    """The model arguments of a batch: the Serenade streams, and the
    variant's unrolled ``f0_fluc`` as ``extras["fluc"]``, as the JAX CLI's
    batch adapter hands them (``serenade_tpu/bin/distill.py:158-163``)."""
    kwargs = {}
    if "f0_fluc" in batch:
        kwargs["extras"] = {"fluc": batch["f0_fluc"]}
    return (batch["x"], batch["lengths"], batch["logmel"], batch["midi"],
            batch["loud"]), kwargs


def build_distill_step(model: nn.Module, teacher: nn.Module, opt, *,
                       mode: str = "endpoint", student_steps: int = 2,
                       n_teacher_steps: int = 10, solver: str = "euler",
                       temperature: float = 0.667, device=None):
    """``(state, batch, generator=None, draws=None) -> (state, metrics)``
    for a ``state`` from ``create_train_state(model, opt)``.

    ``model`` is the student, which starts as a copy of ``teacher`` that
    shares no storage with it; ``teacher`` (``frozen_teacher``) is never
    written.  ``student_steps`` is the deployed Euler step count (endpoint
    mode backpropagates through exactly that rollout; reflow ignores it).
    ``generator`` (on the device) draws the pair's segment and ``x0``,
    the reflow loss's flow times and dropout; ``draws`` replaces them:
    ``frac``, ``start``, ``x0`` (and the variant's ``s1``, ``s2``) for the
    pair, ``t`` for the reflow loss.  Metrics ``train/distill_loss``,
    ``train/loss`` and ``train/grad_norm`` (the norm of every gradient,
    the frozen ones as zeros, before clipping), 0-d tensors.  Runs on CUDA
    unless ``device`` says otherwise.  Under the state's ``layout`` (dp)
    each rank passes its rows of the global batch, as to
    ``build_train_step``.
    """
    if mode not in ("endpoint", "reflow"):
        raise ValueError(f"unknown distillation mode '{mode}'")
    dev = resolve_device(device)
    for name, m in (("student", model), ("teacher", teacher)):
        bad = [n for n, p in m.named_parameters() if p.device.type != dev.type]
        if bad:
            raise ValueError(f"{name} parameters not on {dev}: {bad[:3]}")
    shared = ({p.data_ptr() for p in model.parameters()}
              & {p.data_ptr() for p in teacher.parameters()})
    if shared:
        raise ValueError("the student shares storage with the teacher: "
                         "its updates would move the teacher")

    def loss_fn(pair, generator, draws):
        cfm = model.cfm_decoder
        if mode == "endpoint":
            # the masked MSE of the student's rollout to the endpoint
            out = cfm.rollout(pair["mu"], pair["mask"], pair["spk"],
                              pair["x0"], n_timesteps=student_steps,
                              solver="euler")
            err = torch.square((out - pair["x1_hat"]) * pair["mask"])
            return err.sum() / (torch.clamp(batch_sum(pair["mask"].sum()),
                                            min=1.0) * out.shape[-1])
        loss, _ = cfm.compute_loss(
            pair["x1_hat"], pair["mask"], pair["mu"], pair["spk"],
            mask_l=pair["mask"], t=draws.get("t"), generator=generator,
            x0=pair["x0"], train=True)
        return loss

    def step_fn(state: TrainState, batch: Mapping[str, Any],
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None):
        batch = {k: to_device(v, dev) for k, v in batch.items()}
        layout = state.layout
        shard = (None if layout is None
                 else layout.batch_shard(batch["x"].shape[0]))
        draws = local_draws(draws or {}, shard)
        args, kwargs = _batch_args(batch)
        params = list(state.params.values())
        for p in params:
            p.grad = None
        with sharded_batch(shard):
            pair = teacher.make_reflow_batch(
                *args, generator=generator, draws=draws,
                n_timesteps=n_teacher_steps, temperature=temperature,
                solver=solver, **kwargs)
            loss = loss_fn(pair, generator, draws)
            loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        loss = loss.detach()
        if layout is not None:
            loss = layout.reduce_metrics(loss)
        metrics = dict.fromkeys(METRICS, loss)
        metrics["train/grad_norm"] = apply_update(opt, state, grads)
        state.step += 1
        return state, metrics

    return step_fn


def distill_config_overrides(config: Dict[str, Any]) -> Dict[str, Any]:
    """Config keys a distilled checkpoint carries, so that decode and
    serving pick the fast sampler by default."""
    out = dict(config)
    out["distilled"] = True
    out.setdefault("inference_n_timesteps", 2)
    out.setdefault("inference_solver", "euler")
    return out
