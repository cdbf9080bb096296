"""SiFiGAN input features (counterpart of serenade_tpu/sifigan/
features.py): the sine excitation, the per-level dense dilation factors
and the aux features (mel-cepstrum and band aperiodicity).

At network level i the temporal rate is ``fs * cumprod(scales)[i] /
prod(scales)``; a pitch-dependent conv with ``dense_factor`` taps per
pitch cycle needs the dilation ``rate / (f0 * dense_factor)`` (level
samples, at least 1), computed at frame rate and repeated to each
level's length.  The excitation and the factors are host numpy, with
numpy's generator, so the excitation's noise equals JAX's draw for draw.
``world_mcep_bap`` runs CheapTrick and the aperiodicity on the device in
one bucket-padded call, and ``sp2mc`` on the host.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from serenade_tpu_torch import resolve_device
from serenade_tpu_torch.ops.sptk import ALPHA, sp2mc
from serenade_tpu_torch.ops.world import band_aperiodicity, cheaptrick, d4c

AP_BACKENDS = {"bandap": band_aperiodicity, "d4c": d4c}
# the device path (ops/world.py) and the C++ host library (native.py)
ANALYSIS_BACKENDS = ("device", "native")


def dilated_factor(cf0: np.ndarray, level_rate: float,
                   dense_factor: float) -> np.ndarray:
    """Per-frame dilation in level samples; cf0 ``(T,)`` or ``(T, 1)``."""
    cf0 = np.asarray(cf0, np.float64).reshape(-1)
    return np.maximum(level_rate / (np.maximum(cf0, 1.0) * dense_factor),
                      1.0)


def dense_factors_per_level(cf0: np.ndarray, fs: int,
                            dense_factors: Sequence[float],
                            upsample_scales: Sequence[int]
                            ) -> List[np.ndarray]:
    """Each level's dilation track, repeated to its length (f32)."""
    cum = np.cumprod(upsample_scales)
    return [np.repeat(dilated_factor(cf0, fs * us / cum[-1], df),
                      us).astype(np.float32)
            for df, us in zip(dense_factors, cum)]


class SignalGenerator:
    """Sine, noise or V/UV excitation at the waveform rate from frame F0
    (host numpy; its noise from ``default_rng(seed)`` in call order)."""

    def __init__(self, sample_rate: int = 24000, hop_size: int = 120,
                 sine_amp: float = 0.1, noise_amp: float = 0.003,
                 signal_types: Sequence[str] = ("sine",), seed: int = 100):
        self.sample_rate = sample_rate
        self.hop_size = hop_size
        self.sine_amp = sine_amp
        self.noise_amp = noise_amp
        self.signal_types = tuple(signal_types)
        self.rng = np.random.default_rng(seed)

    def __call__(self, f0: np.ndarray) -> np.ndarray:
        """f0 ``(T,)`` or ``(T, 1)`` -> ``(T * hop, n_types)`` f32."""
        f0_up = np.repeat(np.asarray(f0, np.float64).reshape(-1),
                          self.hop_size)
        n = len(f0_up)
        parts = []
        for kind in self.signal_types:
            if kind == "sine":
                phase = 2.0 * np.pi * np.cumsum(f0_up) / self.sample_rate
                sine = np.where(f0_up > 0, self.sine_amp * np.sin(phase), 0.0)
                parts.append(sine + self.noise_amp
                             * self.rng.standard_normal(n))
            elif kind == "noise":
                parts.append(self.sine_amp / 3.0
                             * self.rng.standard_normal(n))
            elif kind == "uv":
                parts.append((f0_up > 0).astype(np.float64))
            else:
                raise ValueError(f"unknown signal type {kind!r}")
        return np.stack(parts, axis=-1).astype(np.float32)


def world_mcep_bap(wav, f0, fs: int, frame_period_ms: float, mcep_dim: int,
                   ap_backend: str = "bandap",
                   analysis_backend: str = "device", device=None):
    """CheapTrick + aperiodicity analysis -> ``(mcep, bap, sp)`` numpy,
    the SiFiGAN aux-feature contract.

    ``analysis_backend="device"`` runs both on the device (the card unless
    ``device`` says otherwise) in one call at a 128-hop bucket, the
    waveform zero-padded and the F0 track padded with unvoiced frames
    (each frame is analysed alone, so the true frames do not change);
    ``"native"`` runs the C++ host library (``native.py``), which has
    band aperiodicity only.  ``ap_backend``: "bandap" or "d4c"."""
    if ap_backend not in AP_BACKENDS:
        raise ValueError(f"unknown ap_backend {ap_backend!r}")
    if analysis_backend not in ANALYSIS_BACKENDS:
        raise ValueError(f"unknown analysis_backend {analysis_backend!r} "
                         f"(the port's are {ANALYSIS_BACKENDS})")
    wav = np.asarray(wav, np.float32).reshape(-1)
    f0 = np.asarray(f0, np.float32).reshape(-1)
    t = f0.shape[0]
    if analysis_backend == "native":
        if ap_backend != "bandap":
            raise ValueError("analysis_backend='native' has band "
                             "aperiodicity only (ap_backend='bandap')")
        from serenade_tpu_torch.native import (
            band_aperiodicity_native, cheaptrick_native,
        )

        sp = cheaptrick_native(wav, f0, fs=fs,
                               frame_period_ms=frame_period_ms)
        bap = band_aperiodicity_native(wav, f0, fs=fs,
                                       frame_period_ms=frame_period_ms)
        return sp2mc(sp, order=mcep_dim, alpha=ALPHA[fs]), bap, sp
    dev = resolve_device(device)
    hop = int(fs * frame_period_ms / 1000.0)
    bucket = 128 * hop
    padded = max(-(-len(wav) // bucket) * bucket, bucket)
    t_b = 1 + padded // hop
    wav_b = torch.as_tensor(np.pad(wav, (0, padded - len(wav))), device=dev)
    f0_b = torch.as_tensor(np.pad(f0[:t_b], (0, max(0, t_b - t))),
                           device=dev)
    sp = cheaptrick(wav_b, f0_b, fs=fs, frame_period_ms=frame_period_ms)
    bap = AP_BACKENDS[ap_backend](wav_b, f0_b, fs=fs,
                                  frame_period_ms=frame_period_ms)
    sp, bap = sp[:t].cpu().numpy(), bap[:t].cpu().numpy()
    return sp2mc(sp, order=mcep_dim, alpha=ALPHA[fs]), bap, sp
