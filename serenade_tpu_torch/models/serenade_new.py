"""SerenadeNew: Serenade with F0-fluctuation conditioning (counterpart of
serenade_tpu/models/serenade_new.py).

Two more conditioning channels, after loudness: copies of the frame-level
F0 fluctuation (``features.compute_f0_fluctuation``, ``(B, T, 1)``) rolled
along time by two shifts.  Training rolls the source's own fluctuation
by shifts drawn from ``[0, max(T - 2, 1))``; inference tiles the
reference's padded fluctuation to the source's padded length (``np.resize``
semantics) and rolls both copies, the source's and the reference's, by
shifts drawn from ``[0, max(Ts, 1))``.  Each shift is one scalar for the
whole batch, and the rolls wrap the padding into valid frames, as in the
JAX package.

The shifts may be tensors on the device: rolls and tiles are index
gathers, so drawing them never synchronises the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from serenade_tpu_torch.models.serenade import Serenade

Shift = Union[int, torch.Tensor]


def roll_time(x: torch.Tensor, shift: Shift) -> torch.Tensor:
    """``jnp.roll(x, shift, axis=1)`` of ``(B, T, C)`` as a gather:
    ``out[:, t] = x[:, (t - shift) mod T]``."""
    t = x.shape[1]
    idx = torch.remainder(torch.arange(t, device=x.device) - shift, t)
    return x.index_select(1, idx)


def tile_to_length(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """``np.resize`` along time: ``(B, T, C)`` tiled, then cut to
    ``out_len`` frames."""
    idx = torch.arange(out_len, device=x.device) % x.shape[1]
    return x.index_select(1, idx)


def draw_shifts(high: int, generator: Optional[torch.Generator],
                device) -> torch.Tensor:
    """Two shifts from ``[0, max(high, 1))``, a ``(2,)`` int64 tensor on
    ``device``."""
    return torch.randint(0, max(high, 1), (2,), generator=generator,
                         device=device)


def _rolled_pair(x: torch.Tensor, shifts: Sequence[Shift]) -> torch.Tensor:
    return torch.cat([roll_time(x, shifts[0]), roll_time(x, shifts[1])],
                     dim=-1)


def _train_fluc(f0_fluc, draws, generator) -> torch.Tensor:
    """Training's two copies of ``f0_fluc`` ``(B, T, 1)``, rolled by
    ``draws["s1"]`` and ``draws["s2"]`` where given, else by two draws
    from ``generator`` in ``[0, max(T - 2, 1))``."""
    high = max(f0_fluc.shape[1] - 2, 1)
    shifts = [draws[k] if draws.get(k) is not None else torch.randint(
        0, high, (), generator=generator, device=f0_fluc.device)
        for k in ("s1", "s2")]
    return _rolled_pair(f0_fluc, shifts)


class SerenadeNew(Serenade):
    # a capability the Converter reads: the F0 fluctuation goes through
    # training and inference
    uses_f0_fluc = True

    def __init__(self, *args, fluc_channels: int = 2, **kwargs):
        super().__init__(*args, fluc_channels=fluc_channels, **kwargs)

    def forward(self, x, lengths, logmel, midi, loud,
                f0_fluc: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """``Serenade.forward`` with ``f0_fluc`` ``(B, T, 1)`` rolled by
        ``draws["s1"]`` and ``draws["s2"]`` where given, else by two
        draws from ``generator`` in ``[0, max(T - 2, 1))``."""
        if f0_fluc is None:
            raise ValueError("SerenadeNew needs f0_fluc")
        draws = draws or {}
        return super().forward(x, lengths, logmel, midi, loud,
                               generator=generator, draws=draws,
                               fluc=_train_fluc(f0_fluc, draws, generator))

    def make_reflow_batch(self, x, lengths, logmel, midi, loud, *,
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[Dict[str, torch.Tensor]] = None,
                          extras: Optional[Dict[str, torch.Tensor]] = None,
                          **kwargs) -> Dict[str, torch.Tensor]:
        """``Serenade.make_reflow_batch`` with ``extras["fluc"]``, the
        unrolled ``f0_fluc`` ``(B, T, 1)`` that distillation's batch
        adapter hands over (``serenade_tpu/bin/distill.py:158-163``),
        rolled into the two conditioning channels as ``forward`` rolls it
        (``draws["s1"]``, ``draws["s2"]``, else two draws from
        ``generator``).  The JAX package appends the unrolled track as it
        is, one channel where its parameters take two, and stops on the
        shape (ROADMAP Queue C)."""
        if not extras or extras.get("fluc") is None:
            raise ValueError("SerenadeNew needs extras['fluc'] (f0_fluc)")
        draws = draws or {}
        fluc = _train_fluc(extras["fluc"], draws, generator)
        return super().make_reflow_batch(
            x, lengths, logmel, midi, loud, generator=generator,
            draws=draws, extras=dict(extras, fluc=fluc), **kwargs)

    @torch.no_grad()
    def inference(self, x, lengths, midi, loud, f0_fluc,
                  ref_x, ref_lengths, ref_logmel, ref_midi, ref_loud,
                  ref_f0_fluc, *, generator: Optional[torch.Generator] = None,
                  n_timesteps: int = 10, temperature: float = 0.667,
                  solver: str = "euler", x0: Optional[torch.Tensor] = None,
                  shifts: Optional[Sequence[Shift]] = None):
        """``Serenade.inference`` conditioned on ``ref_f0_fluc`` ``(B, Tr,
        1)`` tiled to the source's padded length and rolled, and on the
        reference's own copy rolled by the same two ``shifts`` (drawn
        from ``generator`` in ``[0, max(Ts, 1))`` where not given).  Of
        ``f0_fluc`` only the length is read, as in the JAX package."""
        ts = f0_fluc.shape[1]
        if shifts is None:
            shifts = draw_shifts(ts, generator, x.device)
        return super().inference(
            x, lengths, midi, loud, ref_x, ref_lengths, ref_logmel, ref_midi,
            ref_loud, generator=generator, n_timesteps=n_timesteps,
            temperature=temperature, solver=solver, x0=x0,
            fluc=_rolled_pair(tile_to_length(ref_f0_fluc, ts), shifts),
            ref_fluc=_rolled_pair(ref_f0_fluc, shifts))
