"""Signal-processing helpers (counterpart of serenade_tpu/utils/signal.py):
the low-cut filter and a WORLD-style ``world_extract`` whose analysis
runs on the device: YIN F0 (median-smoothed), the CheapTrick envelope and
band aperiodicity, expanded to a full aperiodicity spectrum on the
host."""

from __future__ import annotations

import numpy as np
import torch

from serenade_tpu_torch import resolve_device
from serenade_tpu_torch.ops.f0 import smooth_f0_median, yin_f0
from serenade_tpu_torch.ops.world import (
    aperiodicity_spectrum, band_aperiodicity, cheaptrick,
)
from serenade_tpu_torch.utils.audio import low_cut_filter  # noqa: F401


def world_extract(x: np.ndarray, fs: int, f0min: float = 70.0,
                  f0max: float = 1100.0, shiftms: float = 5.0,
                  device=None):
    """WORLD-class analysis of one waveform: ``(f0 (T,), spc (T, F), ap
    (T, F), vuv (T,))`` as numpy, the role of the reference's pyworld
    harvest + cheaptrick + d4c (utils/signal.py:108-130).  Runs on the
    card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    wav = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    f0, _ = yin_f0(wav, fs=fs, f0_floor=float(f0min), f0_ceil=float(f0max),
                   frame_period_ms=shiftms)
    f0 = smooth_f0_median(f0)
    spc = cheaptrick(wav, f0, fs=fs, frame_period_ms=shiftms)
    bap = band_aperiodicity(wav, f0, fs=fs, frame_period_ms=shiftms)
    f0, spc, bap = (a.cpu().numpy() for a in (f0, spc, bap))
    ap = aperiodicity_spectrum(bap, fs, (spc.shape[1] - 1) * 2)
    return f0, spc, ap, (f0 > 0).astype(np.float32)
