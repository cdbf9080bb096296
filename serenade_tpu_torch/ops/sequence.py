"""Time packing of reference‖source (counterpart of
serenade_tpu/ops/sequence.py).  Offsets are per sample: batch rows may
carry different reference lengths."""

from __future__ import annotations

import torch


def _row_index(offsets: torch.Tensor, length: int) -> torch.Tensor:
    return offsets[:, None] + torch.arange(length, device=offsets.device)


def pack_pair_time(ref, ref_lengths, src, src_lengths):
    """``ref[b, :rl]`` followed by all of ``src[b]`` along time.

    Args:
        ref: (B, Tr, C) bucket-padded reference features.
        ref_lengths: (B,) valid reference lengths.
        src: (B, Ts, C) bucket-padded source features.
        src_lengths: (B,) valid source lengths.

    Returns:
        packed (B, Tr+Ts, C) and total lengths ``ref_lengths + src_lengths``.
    """
    b, tr, c = ref.shape
    ts = src.shape[1]
    out = torch.zeros((b, tr + ts, c), dtype=ref.dtype, device=ref.device)
    out[:, :tr] = ref
    idx = _row_index(ref_lengths.long(), ts)[:, :, None].expand(b, ts, c)
    out.scatter_(1, idx, src.to(ref.dtype))
    return out, ref_lengths + src_lengths


def unpack_suffix_time(packed, offsets, out_len: int):
    """Per-sample windows ``packed[b, offsets[b] : offsets[b] + out_len]``."""
    b, _, c = packed.shape
    idx = _row_index(offsets.long(), out_len)[:, :, None].expand(b, out_len, c)
    return torch.gather(packed, 1, idx)
