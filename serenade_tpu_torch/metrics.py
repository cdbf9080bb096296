"""Objective evaluation metrics for conversion outputs (counterpart of
serenade_tpu/metrics.py).

* **MCD**: mel-cepstral distortion (dB) over CheapTrick envelopes coded to
  mel-cepstra (``ops/world.cheaptrick`` + ``ops/sptk.sp2mc``), DTW-aligned
  by default so that a global time offset does not read as spectral
  error;
* **log-F0 RMSE** (cents) over frames both signals voice;
* **V/UV error**: the share of frames whose voicing decisions disagree.

The analysis (F0 and the envelope) runs on the device, same-bucket
waveforms batched together, with the length buckets of preprocessing
(``features._bucketed``) and groups padded to powers of two, as in the
JAX package; the mel-cepstral recursion and DTW are host numpy.  F0
backends: "viterbi" (YIN + the Viterbi trellis kernel, the default),
"yin" and "harvest" (``ops/harvest.py``, its trellis on the same
kernel).
Everything runs on CUDA unless ``device`` says otherwise.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from serenade_tpu_torch import resolve_device, upload
from serenade_tpu_torch.collaters.ssc import pad_pow2
from serenade_tpu_torch.features import (
    F0_BACKENDS, _bucketed, check_f0_backend,
)
from serenade_tpu_torch.ops.sptk import ALPHA, sp2mc
from serenade_tpu_torch.ops.world import cheaptrick
from serenade_tpu_torch.utils.audio import to_mono

logger = logging.getLogger(__name__)

_LOG_SPEC = 10.0 / np.log(10.0)
_MCD_SCALE = _LOG_SPEC * np.sqrt(2.0)
_CENTS = 1200.0 / np.log(2.0)


def _check_eval_wav(wav: np.ndarray, name: str) -> np.ndarray:
    """Refuse a corrupt waveform before analysis: one NaN wav would
    poison the corpus means of ``summarize`` silently.  (No [-1, 1]
    bound: resampled targets may overshoot.)"""
    wav = np.asarray(wav, np.float32)
    if wav.size == 0:
        raise ValueError(f"{name}: empty waveform")
    if not np.isfinite(wav).all():
        raise ValueError(f"{name}: non-finite samples")
    return wav


@torch.no_grad()
def _analysis(wavs: np.ndarray, fs: int, frame_period_ms: float,
              f0_floor: float, f0_ceil: float, backend: str, device):
    """F0, V/UV and the log CheapTrick envelope of same-length waveforms
    ``(B, L)`` in one batched pass on ``device``; numpy ``(B, T)``,
    ``(B, T)``, ``(B, T, F)``."""
    wav = upload(wavs, device, np.float32)
    f0, vuv = F0_BACKENDS[backend](wav, fs=fs, f0_floor=f0_floor,
                                   f0_ceil=f0_ceil,
                                   frame_period_ms=frame_period_ms)
    env = cheaptrick(wav, f0, fs=fs, f0_floor=f0_floor,
                     frame_period_ms=frame_period_ms)
    log_env = torch.log(torch.clamp(env, min=1e-12))
    return f0.cpu().numpy(), vuv.cpu().numpy(), log_env.cpu().numpy()


def _feats(f0, vuv, log_env, n: int, sr: int, mcep_order: int):
    return {"mcep": sp2mc(log_env[:n], mcep_order, ALPHA.get(sr, 0.466),
                          log_input=True).astype(np.float32),
            "f0": f0[:n].astype(np.float32),
            "vuv": vuv[:n].astype(np.float32)}


def extract_eval_feats(
    wav: np.ndarray,
    sr: int,
    *,
    frame_period_ms: float = 5.0,
    f0_floor: float = 70.0,
    f0_ceil: float = 1100.0,
    f0_backend: str = "viterbi",
    mcep_order: int = 34,
    device=None,
) -> Dict[str, np.ndarray]:
    """Per-frame analysis of one waveform: mel-cepstrum ``(T, order+1)``,
    f0 ``(T,)`` and vuv ``(T,)``."""
    check_f0_backend(f0_backend, host=False)
    dev = resolve_device(device)
    wav = _check_eval_wav(to_mono(np.asarray(wav)), "eval wav")
    hop = int(sr * frame_period_ms / 1000.0)
    wav_b, n_frames = _bucketed(wav, hop)
    f0, vuv, log_env = _analysis(wav_b[None], sr, frame_period_ms,
                                 f0_floor, f0_ceil, f0_backend, dev)
    return _feats(f0[0], vuv[0], log_env[0], n_frames, sr, mcep_order)


def extract_eval_feats_batch(
    wavs,
    sr: int,
    *,
    frame_period_ms: float = 5.0,
    f0_floor: float = 70.0,
    f0_ceil: float = 1100.0,
    f0_backend: str = "viterbi",
    mcep_order: int = 34,
    max_group: int = 8,
    device=None,
):
    """:func:`extract_eval_feats` over many waveforms: same-bucket clips
    go through one batched analysis, up to ``max_group`` a pass, each
    group padded to a power of two by repeating its last waveform (as
    the JAX package pads; every row's numbers are those of its lone
    analysis up to the batched ops' rounding).  Returns the feature dicts
    in input order; a corrupt waveform gives ``None`` at its index (and a
    warning) instead of failing its batch."""
    check_f0_backend(f0_backend, host=False)
    dev = resolve_device(device)
    hop = int(sr * frame_period_ms / 1000.0)
    prepped = [None] * len(wavs)
    for i, w in enumerate(wavs):
        try:
            prepped[i] = _bucketed(
                _check_eval_wav(to_mono(np.asarray(w)), f"wav[{i}]"), hop)
        except ValueError:
            logger.warning("skipping corrupt eval waveform %d", i,
                           exc_info=True)
    groups: Dict[int, list] = {}
    for i, pr in enumerate(prepped):
        if pr is not None:
            groups.setdefault(pr[0].shape[0], []).append(i)

    out = [None] * len(prepped)
    for idxs in groups.values():
        for lo in range(0, len(idxs), max_group):
            chunk = idxs[lo:lo + max_group]
            f0, vuv, log_env = _analysis(
                np.stack([prepped[i][0] for i in pad_pow2(chunk)]), sr,
                frame_period_ms, f0_floor, f0_ceil, f0_backend, dev)
            for row, i in enumerate(chunk):
                out[i] = _feats(f0[row], vuv[row], log_env[row],
                                prepped[i][1], sr, mcep_order)
    return out


def dtw_path(cost: np.ndarray, band_frac: float = 0.25):
    """Dynamic-time-warping alignment through a ``(T1, T2)`` cost matrix;
    returns (idx1, idx2), monotone index arrays of the optimal path.

    The accumulation runs over anti-diagonal wavefronts (each depends only
    on the previous two), T1 + T2 vectorized steps, inside a Sakoe-Chiba
    band of radius ``max(|T1 - T2| + 32, band_frac · max(T1, T2))`` around
    the scaled diagonal (``band_frac=1`` disables it).  The f32
    accumulator is ``(T1, T2)``: prefer a coarser frame period for
    minute-long clips.
    """
    t1, t2 = cost.shape
    if t1 * t2 > 16_000_000:
        logger.warning("dtw over %dx%d frames (%.0f MB); consider a larger "
                       "frame_period_ms for long clips", t1, t2,
                       t1 * t2 * 8e-6)
    radius = max(abs(t1 - t2) + 32, int(band_frac * max(t1, t2)))
    acc = np.full((t1, t2), np.inf, np.float32)
    acc[0, 0] = cost[0, 0]
    scale = t2 / max(t1, 1)
    for d in range(1, t1 + t2 - 1):
        i = np.arange(max(0, d - t2 + 1), min(t1, d + 1))
        j = d - i
        in_band = np.abs(i * scale - j) <= radius
        i, j = i[in_band], j[in_band]
        if not len(i):
            continue
        cand = np.full((3, len(i)), np.inf, np.float32)
        up = i > 0
        cand[0, up] = acc[i[up] - 1, j[up]]
        left = j > 0
        cand[1, left] = acc[i[left], j[left] - 1]
        diag = up & left
        cand[2, diag] = acc[i[diag] - 1, j[diag] - 1]
        acc[i, j] = cost[i, j] + cand.min(axis=0)
    i, j = t1 - 1, t2 - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            k = int(np.argmin((acc[i - 1, j - 1], acc[i - 1, j],
                               acc[i, j - 1])))
            if k == 0:
                i, j = i - 1, j - 1
            elif k == 1:
                i -= 1
            else:
                j -= 1
        path.append((i, j))
    path.reverse()
    p = np.asarray(path)
    return p[:, 0], p[:, 1]


def _cepstral_alignment(mc1: np.ndarray, mc2: np.ndarray):
    """DTW path (idx1, idx2) and the per-pair cepstral distances over
    c1..cD."""
    a, b = mc1[:, 1:], mc2[:, 1:]
    # the Euclidean distance matrix without materializing (T1, T2, D)
    sq = (np.sum(a**2, axis=1)[:, None] + np.sum(b**2, axis=1)[None, :]
          - 2.0 * (a @ b.T))
    dist = np.sqrt(np.maximum(sq, 0.0))
    i, j = dtw_path(dist)
    return i, j, dist[i, j]


def mel_cepstral_distortion(mc1: np.ndarray, mc2: np.ndarray, *,
                            use_dtw: bool = True) -> float:
    """MCD in dB over c1..cD (c0, the overall energy, excluded).
    ``use_dtw`` aligns the sequences on the cepstral distance; otherwise
    frames pair up to the shorter length."""
    if use_dtw:
        _, _, per_frame = _cepstral_alignment(mc1, mc2)
    else:
        a, b = mc1[:, 1:], mc2[:, 1:]
        n = min(len(a), len(b))
        per_frame = np.sqrt(np.sum((a[:n] - b[:n]) ** 2, axis=1))
    return float(_MCD_SCALE * np.mean(per_frame))


def f0_rmse_cents(f0a: np.ndarray, f0b: np.ndarray) -> Optional[float]:
    """RMSE of log-F0 in cents over frames both signals voice (None when
    no frame qualifies)."""
    n = min(len(f0a), len(f0b))
    both = (f0a[:n] > 0) & (f0b[:n] > 0)
    if not both.any():
        return None
    d = _CENTS * (np.log(f0a[:n][both]) - np.log(f0b[:n][both]))
    return float(np.sqrt(np.mean(d**2)))


def vuv_error_rate(f0a: np.ndarray, f0b: np.ndarray) -> float:
    """The share of frames whose voicing decisions disagree."""
    n = min(len(f0a), len(f0b))
    return float(np.mean((f0a[:n] > 0) != (f0b[:n] > 0)))


def pair_metrics(fa: Dict[str, np.ndarray], fb: Dict[str, np.ndarray],
                 *, use_dtw: bool = True) -> Dict[str, Optional[float]]:
    """All metrics of two extracted feature dicts.  Under ``use_dtw`` the
    one cepstral alignment pairs the frames of every metric, F0 and V/UV
    too."""
    if use_dtw:
        i, j, per_frame = _cepstral_alignment(fa["mcep"], fb["mcep"])
        mcd = float(_MCD_SCALE * np.mean(per_frame))
        f0a, f0b = fa["f0"][i], fb["f0"][j]
        frames = float(len(i))
    else:
        mcd = mel_cepstral_distortion(fa["mcep"], fb["mcep"],
                                      use_dtw=False)
        f0a, f0b = fa["f0"], fb["f0"]
        frames = float(min(len(f0a), len(f0b)))
    return {
        "mcd_db": mcd,
        "f0_rmse_cents": f0_rmse_cents(f0a, f0b),
        "vuv_error": vuv_error_rate(f0a, f0b),
        "frames": frames,
    }


def evaluate_pair(wav_a: np.ndarray, wav_b: np.ndarray, sr: int, *,
                  use_dtw: bool = True, **analysis_kwargs
                  ) -> Dict[str, Optional[float]]:
    """All metrics of one (converted, target) waveform pair."""
    fa = extract_eval_feats(wav_a, sr, **analysis_kwargs)
    fb = extract_eval_feats(wav_b, sr, **analysis_kwargs)
    return pair_metrics(fa, fb, use_dtw=use_dtw)


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / denom) if denom > 0 else 0.0


def summarize(per_utt: Dict[str, Dict[str, Optional[float]]]) -> Dict:
    """Means over utterances (None-valued entries skipped per metric)."""
    out: Dict[str, float] = {}
    for key in ("mcd_db", "f0_rmse_cents", "vuv_error", "style_cos"):
        vals = [m[key] for m in per_utt.values() if m.get(key) is not None]
        if vals:
            out[key] = float(np.mean(vals))
    out["n_utts"] = len(per_utt)
    return out
