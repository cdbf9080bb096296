"""Framewise onset/offset decoding to note events, host numpy (copied
from serenade_tpu/modules/phoneme_midi/decoding.py): the three frame
logits through a sigmoid, onset and offset peaks picked, notes segmented
between onsets (the offset chosen by offset-peak or activation-dropout
confidence), each note's pitch summarized from an F0 track (median,
Hann-weighted mean or weighted median).

Without a given F0 track the decoder estimates one with the port's
``yin_f0_viterbi`` (``f0_mode: "viterbi"``, the default; its trellis runs
the Viterbi kernel on the card) or plain ``yin_f0`` (``"yin"``), on the
device of ``device``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from serenade_tpu_torch.ops.midi import hz_to_midi


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def peak_select(pred: np.ndarray, threshold: float) -> np.ndarray:
    """Keep only the local maximum of each supra-threshold run."""
    out = np.zeros_like(pred)
    local_max_idx = 0
    for i in range(len(pred)):
        if pred[i] > threshold:
            if pred[i] > pred[local_max_idx]:
                local_max_idx = i
        else:
            if local_max_idx != 0:
                out[local_max_idx] = pred[local_max_idx]
                local_max_idx = 0
    return out


def _weighted_median(values: np.ndarray, weights: np.ndarray) -> float:
    order = np.argsort(values)
    v, w = values[order], weights[order]
    cw = np.cumsum(w)
    if cw[-1] <= 0:
        return float("nan")
    return float(v[np.searchsorted(cw, 0.5 * cw[-1])])


def decode_notes(onsets, f0_hz, pitch_sum: str, offsets=None, frames=None
                 ) -> Tuple[List[float], List[Tuple[int, int]]]:
    """Notes between onset peaks: (pitches, frame intervals)."""
    with np.errstate(divide="ignore"):
        f0_midi = np.where(f0_hz > 0, hz_to_midi(np.maximum(f0_hz, 1e-9)),
                           np.nan)

    onset_idx = np.nonzero(np.asarray(onsets) > 0)[0]
    if offsets is not None:
        offset_hit = np.asarray(offsets) > 0
    if frames is not None:
        fq = (np.asarray(frames) >= 0.5).astype(np.float32)
        frame_drop = np.concatenate([fq[:-1] - fq[1:], fq[-1:]]) == 1

    pitches, intervals = [], []
    n = len(onsets)
    for i, onset in enumerate(onset_idx):
        next_onset = onset_idx[i + 1] if i + 1 < len(onset_idx) else n - 1

        offset = None
        offset_conf = 0.0
        frame_conf = 0.0
        for j in range(onset + 2, next_onset):
            if offsets is not None and offset_hit[j]:
                if offset_conf < offsets[j]:
                    offset_conf = offsets[j]
                    offset = j
            if frames is not None and frame_drop[j]:
                conf, k = 0.0, j + 1
                while k < next_onset and frames[k] < 0.5:
                    conf = max(1.0 - frames[k], conf)
                    k += 1
                if frame_conf < conf:
                    frame_conf = conf
                    offset = j
        if offset is None:
            offset = next_onset - 1

        seg = f0_midi[onset:offset + 1]
        valid = ~np.isnan(seg)
        if pitch_sum == "median":
            pitch = (float(np.median(seg[valid])) if valid.any()
                     else float("nan"))
        elif pitch_sum == "weighted_mean":
            w = np.hanning(len(seg) + 2)[1:-1]
            num = np.nansum(seg * w)
            den = w[valid].sum()
            pitch = float(num / den) if den > 0 else float("nan")
        elif pitch_sum == "weighted_median":
            w = np.hanning(len(seg) + 2)[1:-1].copy()
            w[~valid] = 0.0
            pitch = (_weighted_median(np.nan_to_num(seg), w / w.sum())
                     if w.sum() > 0 else float("nan"))
        else:
            raise ValueError(f"unknown pitch_sum {pitch_sum!r}")

        if np.isnan(pitch):
            pitch = 0.0
        if offset > onset:
            pitches.append(pitch)
            intervals.append((int(onset), int(offset) + 1))
    return pitches, intervals


class FramewiseDecoder:
    def __init__(self, config: dict, device=None):
        self.sr = config["sample_rate"]
        self.win_length = config["win_length"]
        self.hop_length = config["hop_length"]
        self.onset_threshold = config["onset_threshold"]
        self.offset_threshold = config["offset_threshold"]
        self.pitch_sum = config["pitch_sum"]
        self.f0_mode = config.get("f0_mode", "viterbi")
        self.device = device

    def decode(self, pred: np.ndarray, audio=None, f0=None):
        """pred ``(T, 3)`` frame logits -> (pitches, frame intervals)."""
        onset = _sigmoid(pred[:, 0])
        offset = _sigmoid(pred[:, 1])
        activation = _sigmoid(pred[:, 2])

        onsets = peak_select(onset, self.onset_threshold)
        offsets = peak_select(offset, self.offset_threshold)

        if f0 is None:
            if audio is None:
                raise ValueError("either audio or f0 must be given")
            import torch

            from serenade_tpu_torch import resolve_device
            from serenade_tpu_torch.ops.f0 import yin_f0, yin_f0_viterbi

            estimate = yin_f0_viterbi if self.f0_mode == "viterbi" else yin_f0
            f0_t, _ = estimate(
                torch.as_tensor(np.asarray(audio, np.float32),
                                device=resolve_device(self.device)),
                fs=self.sr, f0_floor=65.0, f0_ceil=2093.0,
                frame_period_ms=self.hop_length * 1000.0 / self.sr,
                win_length=self.win_length)
            f0 = f0_t.cpu().numpy()
        n = min(len(f0), len(onsets))
        return decode_notes(onsets[:n], f0[:n], self.pitch_sum,
                            offsets=offsets[:n], frames=activation[:n])
