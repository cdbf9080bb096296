"""Batch collation with bucketed padding (counterpart of
serenade_tpu/collaters/ssc.py).

Lengths pad up to the next 64-frame bucket (a handful of shapes, so the
kernels' launch plans repeat), or to one fixed ``pad_frames_to`` with
lengths clamped.  Utterances of ``max_frames`` (3000) or more are dropped
and the batch is sorted longest first, as in the reference.  Keys
``xs/lens/ys/louds/scores`` (``SSCCollaterNew`` adds ``f0_flucs``),
channels last ``(B, T, C)``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def bucket_length(n: int, multiple: int = 64, min_len: int = 64) -> int:
    return max(min_len, ((n + multiple - 1) // multiple) * multiple)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (and >= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def pad_pow2(seq: Sequence) -> list:
    """A non-empty sequence padded to the next power-of-two length by
    repeating its last element (callers drop the padding's results)."""
    seq = list(seq)
    return seq + [seq[-1]] * (next_pow2(len(seq)) - len(seq))


def pad_to(x: np.ndarray, length: int) -> np.ndarray:
    pad = length - x.shape[0]
    if pad <= 0:
        return x[:length]
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, widths)


class SSCCollater:
    FEATURE_KEYS = {"xs": "hubert", "ys": "logmel", "louds": "loud",
                    "scores": "score"}

    def __init__(self, max_frames: int = 3000,
                 pad_batch_to: int | None = None,
                 pad_frames_to: int | None = None,
                 host_dtype: str | None = None):
        """``host_dtype``: ``"float32"`` (default: numpy arrays) or
        ``"bfloat16"``: the features leave as CPU ``torch.bfloat16``
        tensors (numpy has no bf16), rounded to nearest even from the
        items' f32 values, as the JAX package's ``ml_dtypes`` arrays are.
        bf16 also rounds the regression target ``ys``."""
        self.max_frames = max_frames
        self.pad_batch_to = pad_batch_to
        self.pad_frames_to = pad_frames_to
        if host_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"host_dtype must be float32 or bfloat16, got "
                             f"{host_dtype!r}")
        self.bf16 = host_dtype == "bfloat16"

    def _filter_sort(self, batch: Sequence[dict]) -> List[dict]:
        kept = [b for b in batch if b["hubert"].shape[0] < self.max_frames]
        return sorted(kept, key=lambda b: -b["hubert"].shape[0])

    def __call__(self, batch: Sequence[dict]) -> Dict[str, object]:
        items = self._filter_sort(batch)
        if not items:
            raise ValueError("collater received an empty batch after "
                             "filtering")
        lens = np.array([b["hubert"].shape[0] for b in items], np.int32)
        if self.pad_frames_to:
            T = int(self.pad_frames_to)
            lens = np.minimum(lens, T)
        else:
            T = bucket_length(int(lens.max()))
        nb = max(len(items), self.pad_batch_to or 0)

        out = {"lens": np.concatenate(
            [lens, np.zeros(nb - len(items), np.int32)])}
        for out_key, src_key in self.FEATURE_KEYS.items():
            first = np.asarray(items[0][src_key])
            arr = np.zeros((nb, T) + first.shape[1:], np.float32)
            for j, b in enumerate(items):
                x = np.asarray(b[src_key])[:T]
                arr[j, :x.shape[0]] = x
            out[out_key] = (torch.from_numpy(arr).to(torch.bfloat16)
                            if self.bf16 else arr)
        return out


class SSCCollaterNew(SSCCollater):
    """Pads the F0-fluctuation stream too, as ``f0_flucs``."""

    FEATURE_KEYS = dict(SSCCollater.FEATURE_KEYS, f0_flucs="f0_fluc")
