"""Bucketed padding helpers (copied from serenade_tpu/collaters/ssc.py)."""

from __future__ import annotations

import numpy as np


def bucket_length(n: int, multiple: int = 64, min_len: int = 64) -> int:
    return max(min_len, ((n + multiple - 1) // multiple) * multiple)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (and >= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def pad_to(x: np.ndarray, length: int) -> np.ndarray:
    pad = length - x.shape[0]
    if pad <= 0:
        return x[:length]
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, widths)
