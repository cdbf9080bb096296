"""Sequence masks (counterpart of serenade_tpu/utils/masking.py).

Lengths and segment bounds are tensors (or Python ints); each mask is made
on the device of the tensor it is given, or on ``device`` when its bounds
are ints."""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, maxlen: int,
                dtype=torch.float32) -> torch.Tensor:
    """``(B, maxlen)`` mask, 1 at positions below each row's length."""
    pos = torch.arange(maxlen, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)


def make_pad_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """Boolean ``(B, maxlen)`` mask, True at padded positions."""
    return ~length_mask(lengths, maxlen, dtype=torch.bool)


def make_non_pad_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """Boolean ``(B, maxlen)`` mask, True at valid positions."""
    return length_mask(lengths, maxlen, dtype=torch.bool)


def segment_mask(seg_start, seg_end, maxlen: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """``(maxlen,)`` mask, 1 inside ``[seg_start, seg_end)``; the bounds
    may be 0-d tensors (the train step's segment draw)."""
    for bound in (seg_start, seg_end):
        if isinstance(bound, torch.Tensor):
            device = bound.device
    pos = torch.arange(maxlen, device=device)
    return ((pos >= seg_start) & (pos < seg_end)).to(dtype)
