"""Optimal-transport conditional flow matching (counterpart of
serenade_tpu/models/cfm.py): the masked training loss and the ODE
sampler."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from serenade_tpu_torch.models.layers import as_dtype
from serenade_tpu_torch.models.unet import Decoder


class CFM(nn.Module):
    def __init__(self, in_channels: int = 80, out_channels: int = 80,
                 spk_embed_dim: int = 256,
                 decoder_channels: Tuple[int, ...] = (512, 512),
                 decoder_attention_head_dim: int = 512,
                 dtype=torch.float32, sigma_min: float = 1e-4,
                 dropout: float = 0.05):
        super().__init__()
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
            t = torch.rand((b,), generator=generator, device=dev)
        if x0 is not None:
            z = x0
        elif z is None:
            z = torch.randn(x1.shape, generator=generator, device=dev)
        t3 = t.float().reshape(b, 1, 1)
        z = z.float()
        x1f = x1.float()
        y = (1.0 - (1.0 - self.sigma_min) * t3) * z + t3 * x1f
        u = x1f - (1.0 - self.sigma_min) * z
        v = self.estimator(y.to(self.dtype), mask, mu, t3[:, 0, 0], spk,
                           train=train, generator=generator)
        norm_mask = mask_l if mask_l is not None else mask
        err = torch.square((v - u) * norm_mask)
        loss = err.sum() / (torch.clamp(norm_mask.sum(), min=1.0) * c)
        return loss, y

    @torch.no_grad()
    def inference(self, mu, mask, spk, *, n_timesteps: int = 10,
                  temperature: float = 0.667,
                  generator: Optional[torch.Generator] = None,
                  solver: str = "euler",
                  x0: Optional[torch.Tensor] = None):
        """ODE sampling from ``z·temperature`` (or the pre-scaled ``x0``,
        to which temperature is not re-applied) over a uniform t grid.

        Solvers: ``euler`` (1 estimator evaluation per step), ``midpoint``
        (2), ``ab2`` (Adams-Bashforth 2, 1 per step after one Euler step).
        Returns ``(B, T, out_channels)`` f32 mels, valid under ``mask``.
        """
        b, T, _ = mu.shape
        if x0 is None:
            z = torch.randn((b, T, self.out_channels), generator=generator,
                            dtype=torch.float32, device=mu.device)
            z = z * temperature
        else:
            z = x0.float().to(mu.device)
        ts = torch.linspace(0.0, 1.0, n_timesteps + 1,
                            dtype=torch.float32).tolist()

        def f(x, t):
            tt = torch.full((b,), t, dtype=torch.float32, device=mu.device)
            return self.estimator(x.to(self.dtype), mask, mu, tt, spk).float()

        x = z
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
