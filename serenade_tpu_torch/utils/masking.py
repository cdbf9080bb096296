"""Sequence masks (counterpart of serenade_tpu/utils/masking.py)."""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, maxlen: int,
                dtype=torch.float32) -> torch.Tensor:
    """``(B, maxlen)`` mask, 1 at positions below each row's length."""
    pos = torch.arange(maxlen, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)
