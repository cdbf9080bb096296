"""Optimal-transport conditional flow matching (counterpart of
serenade_tpu/models/cfm.py): the masked training loss and the ODE
sampler."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from serenade_tpu_torch.models.layers import as_dtype
from serenade_tpu_torch.models.unet import Decoder
from serenade_tpu_torch.parallel.mesh import (
    batch_draw, batch_sum, current_shard, sharded_batch,
)


class CFM(nn.Module):
    def __init__(self, in_channels: int = 80, out_channels: int = 80,
                 spk_embed_dim: int = 256,
                 decoder_channels: Tuple[int, ...] = (512, 512),
                 decoder_attention_head_dim: int = 512,
                 dtype=torch.float32, sigma_min: float = 1e-4,
                 dropout: float = 0.05, remat: bool = False):
        """``remat``: the training estimator keeps no activations for the
        backward pass and runs again there (``torch.utils.checkpoint``;
        the same gradients, less memory)."""
        super().__init__()
        self.remat = remat
        self.out_channels = out_channels
        self.sigma_min = sigma_min
        self.dtype = as_dtype(dtype)
        self.estimator = Decoder(in_channels, out_channels,
                                 channels=tuple(decoder_channels),
                                 attention_head_dim=decoder_attention_head_dim,
                                 spk_dim=spk_embed_dim, dropout=dropout,
                                 dtype=dtype)

    def compute_loss(self, x1, mask, mu, spk, *,
                     mask_l: Optional[torch.Tensor] = None,
                     t: Optional[torch.Tensor] = None,
                     z: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     x0: Optional[torch.Tensor] = None, train: bool = False):
        """Masked CFM loss (``serenade_tpu/models/cfm.py:57-98``).

        x1 ``(B, T, C)`` target (already loss-masked), mask ``(B, T, 1)``,
        mu ``(B, T, in - out)``, spk ``(B, spk_dim)``, mask_l the infill
        segment's loss mask.  ``t`` ``(B,)`` ~ U(0, 1) and ``z`` ~ N(0, 1)
        of x1's shape are drawn from ``generator`` unless given; ``x0``
        (the ReFlow source) replaces z.  ``train`` turns on dropout.

        Returns (scalar f32 loss, the interpolant y).
        """
        b, T, c = x1.shape
        dev = x1.device
        if t is None:
            t = batch_draw(torch.rand, (b,), generator=generator, device=dev)
        if x0 is not None:
            z = x0
        elif z is None:
            z = batch_draw(torch.randn, x1.shape, generator=generator,
                           device=dev)
        t3 = t.float().reshape(b, 1, 1)
        z = z.float()
        x1f = x1.float()
        y = (1.0 - (1.0 - self.sigma_min) * t3) * z + t3 * x1f
        u = x1f - (1.0 - self.sigma_min) * z
        args = (y.to(self.dtype), mask, mu, t3[:, 0, 0], spk)
        if self.remat and torch.is_grad_enabled():
            v = _rematerialized(self.estimator, args, train, generator)
        else:
            v = self.estimator(*args, train=train, generator=generator)
        norm_mask = mask_l if mask_l is not None else mask
        err = torch.square((v - u) * norm_mask)
        loss = err.sum() / (torch.clamp(batch_sum(norm_mask.sum()), min=1.0)
                            * c)
        return loss, y

    @torch.no_grad()
    def inference(self, mu, mask, spk, *, n_timesteps: int = 10,
                  temperature: float = 0.667,
                  generator: Optional[torch.Generator] = None,
                  solver: str = "euler",
                  x0: Optional[torch.Tensor] = None):
        """ODE sampling from ``z·temperature`` (or the pre-scaled ``x0``,
        to which temperature is not re-applied) over a uniform t grid, with
        no autograd (:meth:`rollout` is the same loop with it).

        Solvers: ``euler`` (1 estimator evaluation per step), ``midpoint``
        (2), ``ab2`` (Adams-Bashforth 2, 1 per step after one Euler step).
        Returns ``(B, T, out_channels)`` f32 mels, valid under ``mask``.
        """
        b, T, _ = mu.shape
        if x0 is None:
            z = torch.randn((b, T, self.out_channels), generator=generator,
                            dtype=torch.float32, device=mu.device)
            x0 = z * temperature
        return self.rollout(mu, mask, spk, x0.float().to(mu.device),
                            n_timesteps=n_timesteps, solver=solver)

    def rollout(self, mu, mask, spk, x0: torch.Tensor, *,
                n_timesteps: int = 10, solver: str = "euler"):
        """The ODE from ``x0`` ``(B, T, out_channels)`` under the caller's
        grad mode: few-step distillation backpropagates through it
        (``trainers/distill.py``).  The estimator runs as in inference (no
        dropout), rematerialized in the backward pass under ``remat``."""
        b = mu.shape[0]
        # the f32 time grid as Python floats: no tensor to read back, so
        # ``torch.export`` traces it (deploy.py)
        ts = np.linspace(0.0, 1.0, n_timesteps + 1,
                         dtype=np.float32).tolist()
        if torch.compiler.is_exporting():
            return self._rollout_for_export(mu, mask, spk, x0, ts, solver)
        remat = self.remat and torch.is_grad_enabled()

        def f(x, t):
            tt = torch.full((b,), t, dtype=torch.float32, device=mu.device)
            args = (x.to(self.dtype), mask, mu, tt, spk)
            if remat:
                return _rematerialized(self.estimator, args, False,
                                       None).float()
            return self.estimator(*args).float()

        x = x0.float()
        if solver == "euler":
            for t0, t1 in zip(ts[:-1], ts[1:]):
                x = x + (t1 - t0) * f(x, t0)
            return x
        if solver == "midpoint":
            for t0, t1 in zip(ts[:-1], ts[1:]):
                h = t1 - t0
                v1 = f(x, t0)
                x = x + h * f(x + 0.5 * h * v1, t0 + 0.5 * h)
            return x
        if solver == "ab2":
            v_prev = f(x, ts[0])
            x = x + (ts[1] - ts[0]) * v_prev
            for t0, t1 in zip(ts[1:-1], ts[2:]):
                v = f(x, t0)
                x = x + (t1 - t0) * (1.5 * v - 0.5 * v_prev)
                v_prev = v
            return x
        raise ValueError(f"unknown solver '{solver}'")

    def _rollout_for_export(self, mu, mask, spk, x0, ts, solver: str):
        """:meth:`rollout`'s ODE for an exported program: one traced step
        iterated by torch's ``while_loop``, as JAX's ``nn.scan`` iterates
        it, so the program holds the estimator once and not once a step.
        The arithmetic is the loop's: the grid's points and steps are the
        same f32 values, here as tensors.  The step counter stays on the
        host, so the loop's test never waits for the device; each step
        takes its time and width from the front of the grid and rotates
        it (the eager ``scan`` of some PyTorch versions evaluates its body
        once more than it has steps, to learn the outputs' shapes)."""
        from torch._higher_order_ops.while_loop import while_loop

        b = mu.shape[0]
        grid = torch.tensor(ts, dtype=torch.float32, device=mu.device)
        steps = torch.stack([grid[:-1], grid[1:] - grid[:-1]])   # (2, n)

        def f(x, t):
            return self.estimator(x.to(self.dtype), mask, mu, t.expand(b),
                                  spk).float()

        def loop(body, carry, n):
            def cond(i, *_):
                return i < n

            def counted(i, *rest):
                return (i + 1, *body(*rest))

            return while_loop(cond, counted,
                              (torch.zeros((), dtype=torch.int64),
                               *carry))[1:]

        x = x0.float()
        if solver == "euler":
            def euler(x, th):
                return x + th[1, 0] * f(x, th[0, 0]), th.roll(-1, 1)

            return loop(euler, (x, steps), len(ts) - 1)[0]
        if solver == "midpoint":
            def midpoint(x, th):
                t0, h = th[0, 0], th[1, 0]
                v1 = f(x, t0)
                return (x + h * f(x + 0.5 * h * v1, t0 + 0.5 * h),
                        th.roll(-1, 1))

            return loop(midpoint, (x, steps), len(ts) - 1)[0]
        if solver == "ab2":
            v = f(x, steps[0, 0])
            x = x + steps[1, 0] * v
            if len(ts) == 2:
                return x

            def ab2(x, v_prev, th):
                v = f(x, th[0, 0])
                return (x + th[1, 0] * (1.5 * v - 0.5 * v_prev), v,
                        th.roll(-1, 1))

            return loop(ab2, (x, v, steps[:, 1:].contiguous()),
                        len(ts) - 2)[0]
        raise ValueError(f"unknown solver '{solver}'")


def _rematerialized(estimator, args, train, generator):
    """``estimator(*args)`` under ``torch.utils.checkpoint``.  The run in
    the backward pass draws the same dropout masks: the generator is set
    back to its state before the forward run, and afterwards to where the
    caller's draws had left it."""
    from torch.utils.checkpoint import checkpoint

    start = None if generator is None else generator.get_state()
    # the recomputation may run on autograd's thread, which does not see
    # the caller's batch shard (the dropout masks' rows)
    shard = current_shard()
    runs = []

    def run(*a):
        again = bool(runs)
        runs.append(True)
        if start is None or not again:
            return estimator(*a, train=train, generator=generator)
        resume = generator.get_state()
        generator.set_state(start)
        try:        # a recomputation may be stopped early by an exception
            with sharded_batch(shard):
                return estimator(*a, train=train, generator=generator)
        finally:
            generator.set_state(resume)

    return checkpoint(run, *args, use_reentrant=False)
