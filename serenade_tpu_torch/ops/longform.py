"""Long-form conversion: overlapped chunking with crossfaded stitching,
host-side numpy (copied from serenade_tpu/ops/longform.py).

The training distribution caps utterances at 3000 frames (the collater's
drop), so a longer source leaves the model's regime and grows the packed
attention quadratically.  These helpers split frame-aligned feature dicts
into overlapping chunks, run a caller-supplied per-chunk conversion, and
crossfade the overlapping mel regions linearly: long-form output with
bounded compute per chunk.  The chunker only slices, so feature tensors
on the device stay there.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np


def split_chunks(n_frames: int, chunk: int, overlap: int) -> List[tuple]:
    """[(start, end), ...] covering [0, n_frames) with `overlap` shared
    frames between neighbors."""
    if overlap >= chunk:
        # a zero or negative step would yield no span at all, and a stream
        # would emit only its success marker
        raise ValueError(
            f"overlap ({overlap}) must be smaller than chunk ({chunk})")
    if n_frames <= chunk:
        return [(0, n_frames)]
    step = chunk - overlap
    starts = list(range(0, n_frames - overlap, step))
    spans = []
    for s in starts:
        e = min(s + chunk, n_frames)
        spans.append((s, e))
        if e == n_frames:
            break
    return spans


def split_chunks_ramp(n_frames: int, chunk: int, overlap: int,
                      first_chunk: int | None = None) -> List[tuple]:
    """Like :func:`split_chunks`, but the chunk size ramps up from
    ``first_chunk``, doubling until it reaches ``chunk``.

    The first finalized region is emitted after one chunk's extraction and
    conversion, so a small first chunk cuts the time to first audio; later
    chunks grow back to ``chunk`` to keep the count of conversions (and
    their fixed cost) low.
    """
    if not first_chunk or first_chunk >= chunk:
        return split_chunks(n_frames, chunk, overlap)
    if first_chunk <= overlap:
        raise ValueError(
            f"first_chunk ({first_chunk}) must exceed overlap ({overlap})")
    spans = []
    s, size = 0, first_chunk
    while True:
        e = min(s + size, n_frames)
        spans.append((s, e))
        if e == n_frames:
            return spans
        s = e - overlap
        size = min(size * 2, chunk)


class StreamStitcher:
    """Incremental crossfade stitcher: feed per-span mels as they are
    produced; finalized regions come back as soon as no later span's
    crossfade can touch them.  The live form of :func:`stitch_mel_stream`,
    for callers that do not know the span list up front (live input)."""

    def __init__(self):
        self._buf = None  # the not yet final tail of the stitched mel
        self._start = 0
        self._prev_end = 0

    def add(self, span, mel, next_start=None):
        """Blend one span's mel in; returns a list of finalized
        ``(start_frame, mel_segment)`` regions (possibly empty).
        ``next_start`` is the next span's start frame, or None when this
        span is the last (flushes the remainder)."""
        s, e = span
        mel = np.asarray(mel)
        out = []
        if self._buf is None:
            # an owned copy: the caller's array may be read-only
            self._buf = np.array(mel)
            self._prev_end = e
        else:
            ov = self._prev_end - s
            if ov > 0:
                w = np.linspace(0.0, 1.0, ov, dtype=mel.dtype)[:, None]
                self._buf[-ov:] = (self._buf[-ov:] * (1.0 - w)
                                   + mel[:ov] * w)
                self._buf = np.concatenate([self._buf, mel[ov:]], axis=0)
            else:
                self._buf = np.concatenate([self._buf, mel], axis=0)
            self._prev_end = e
        if next_start is None:
            out.append((self._start, self._buf))
            self._buf = None
        else:
            # frames before the next chunk's start can no longer change
            final = next_start - self._start
            if final > 0:
                out.append((self._start, self._buf[:final]))
                self._buf = self._buf[final:]
                self._start = next_start
        return out


def stitch_mel_stream(spans: List[tuple], mels):
    """Crossfade per-span mels into finalized regions as they arrive.

    ``mels`` is an iterable aligned with ``spans`` (one (t, C) mel per
    span, produced lazily); yields ``(start_frame, mel_segment)`` pairs,
    in order and non-overlapping, each as soon as no later span's
    crossfade can touch it: right after the producing span's mel, not
    after the whole utterance.  Shared by the feature-sliced
    (:func:`convert_in_chunks_stream`) and windowed-extraction
    (``api.Converter.convert_wav_stream``) long-form paths.
    """
    stitcher = StreamStitcher()
    for i, (span, mel) in enumerate(zip(spans, mels)):
        next_start = spans[i + 1][0] if i + 1 < len(spans) else None
        yield from stitcher.add(span, mel, next_start)


def convert_in_chunks_stream(
    feats: Dict[str, np.ndarray],
    convert_fn: Callable[[Dict[str, np.ndarray]], np.ndarray],
    chunk_frames: int = 2048,
    overlap_frames: int = 256,
):
    """Streaming form: a generator of ``(start_frame, mel_segment)``
    pairs, in order and non-overlapping, each emitted as soon as it is
    final (no later chunk's crossfade can touch it).  The first output
    arrives after one chunk instead of the whole utterance.
    """
    lengths = {k: v.shape[0] for k, v in feats.items()}
    n = min(lengths.values())
    spans = split_chunks(n, chunk_frames, overlap_frames)
    mels = (
        convert_fn({k: v[s:e] for k, v in feats.items()}) for s, e in spans
    )
    yield from stitch_mel_stream(spans, mels)


def convert_in_chunks(
    feats: Dict[str, np.ndarray],
    convert_fn: Callable[[Dict[str, np.ndarray]], np.ndarray],
    chunk_frames: int = 2048,
    overlap_frames: int = 256,
) -> np.ndarray:
    """Run ``convert_fn`` on overlapping windows of the frame-aligned
    feature dict and crossfade the outputs (the offline form of the
    stream).

    Args:
        feats: dict of (T, C) arrays (all same T).
        convert_fn: maps a chunked feature dict -> (t, C_out) mel.
    """
    segs = [seg for _, seg in convert_in_chunks_stream(
        feats, convert_fn, chunk_frames, overlap_frames)]
    return segs[0] if len(segs) == 1 else np.concatenate(segs, axis=0)
