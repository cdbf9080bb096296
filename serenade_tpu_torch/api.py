"""Conversion API (counterpart of serenade_tpu/api.py ``Converter``,
``convert_features`` only).

Everything comes in as data: model and vocoder configs as dicts
(``configs.py`` holds the full-width ones), parameters as a flax tree of
numpy arrays or a state dict (None draws seeded random weights), scaler
statistics as arrays::

    scaler = {"hubert": {"mean": m, "scale": s},
              "score": {"min": lo, "max": hi},
              "loud": {"min": lo, "max": hi},
              "logmel": {"mean": m, "scale": s}}

(sklearn's ``mean_``/``scale_`` and ``data_min_``/``data_max_``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from serenade_tpu_torch import resolve_device
from serenade_tpu_torch.collaters.ssc import bucket_length, pad_to
from serenade_tpu_torch.convert import load_params
from serenade_tpu_torch.models.layers import (
    init_params_,
    store_compute_weights_,
)
from serenade_tpu_torch.models.serenade import Serenade
from serenade_tpu_torch.vocoder.vocoder import Vocoder


class Converter:
    def __init__(self, model_config: Mapping, params, scaler: Mapping, *,
                 vocoder_config: Optional[Mapping] = None,
                 vocoder_params=None, vocoder_stats: Optional[Mapping] = None,
                 n_timesteps: int = 10, solver: str = "euler",
                 temperature: float = 0.667, seed: int = 0, device=None):
        """``vocoder_config`` None converts to mel only.  Runs on CUDA
        unless ``device`` says otherwise."""
        self.device = resolve_device(device)
        model = Serenade(**model_config)
        if params is None:
            init_params_(model, seed)
        else:
            load_params(model, params)
        self.model = store_compute_weights_(model.to(self.device).eval())
        self.scaler = {k: {kk: np.asarray(vv, np.float32)
                           for kk, vv in v.items()} for k, v in scaler.items()}
        self.n_timesteps, self.solver = n_timesteps, solver
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.vocoder = None
        if vocoder_config is not None:
            self.vocoder = Vocoder(
                vocoder_config, vocoder_params, vocoder_stats,
                trg_stats=self.scaler["logmel"], device=self.device,
                seed=seed + 1)

    @property
    def output_sample_rate(self) -> Optional[int]:
        return self.vocoder.sampling_rate if self.vocoder else None

    def _normalize(self, feats: Mapping[str, np.ndarray], with_mel: bool):
        s = self.scaler

        def minmax(x, st):
            return (x - st["min"]) / (st["max"] - st["min"])

        out = {
            "hubert": (feats["hubert"] - s["hubert"]["mean"])
            / s["hubert"]["scale"],
            "score": minmax(feats["score"], s["score"]),
            "loud": minmax(feats["loud"], s["loud"]),
        }
        if with_mel:
            out["logmel"] = ((feats["logmel"] - s["logmel"]["mean"])
                             / s["logmel"]["scale"])
        return out

    def _pack(self, feats: Dict[str, np.ndarray]):
        t = feats["hubert"].shape[0]
        T = bucket_length(t)

        def pad(a):
            a = np.asarray(a, np.float32)
            if a.ndim == 1:
                a = a[:, None]
            return torch.from_numpy(pad_to(a, T)[None]).to(self.device)

        out = {k: pad(v) for k, v in feats.items()}
        out["lengths"] = torch.tensor([t], dtype=torch.int32,
                                      device=self.device)
        return out, t

    def convert_features(self, src_feats: Mapping[str, np.ndarray],
                         ref_feats: Mapping[str, np.ndarray],
                         x0: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, Optional[np.ndarray],
                                    Optional[int]]:
        """Conversion from extracted, un-normalized features.

        src_feats needs hubert/score/loud; ref_feats additionally logmel.
        ``x0`` ``(1, T_ref_bucket + T_src_bucket, mels)`` replaces the
        noise draw (already scaled by the temperature).

        Returns (mel ``(t_src, mels)``, waveform or None, rate or None).
        """
        src, t_src = self._pack(self._normalize(src_feats, False))
        ref, _ = self._pack(self._normalize(ref_feats, True))
        if x0 is not None:
            x0 = torch.as_tensor(np.asarray(x0, np.float32),
                                 device=self.device)
        mel = self.model.inference(
            src["hubert"], src["lengths"], src["score"], src["loud"],
            ref["hubert"], ref["lengths"], ref["logmel"], ref["score"],
            ref["loud"], generator=self.generator,
            n_timesteps=self.n_timesteps, temperature=self.temperature,
            solver=self.solver, x0=x0)[:, :t_src]
        if self.vocoder is None:
            return mel[0].cpu().numpy(), None, None
        wav = self.vocoder.synthesize(mel)[0]
        return (mel[0].cpu().numpy(), wav.cpu().numpy(),
                self.vocoder.sampling_rate)
