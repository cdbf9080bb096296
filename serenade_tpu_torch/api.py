"""Conversion API (counterpart of serenade_tpu/api.py ``Converter``:
``convert_features``, ``pack_reference`` and ``convert_features_batch``).

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

import threading
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from serenade_tpu_torch import resolve_device, upload
from serenade_tpu_torch.collaters.ssc import bucket_length, next_pow2, pad_to
from serenade_tpu_torch.configs import FEATURE_CONFIG
from serenade_tpu_torch.convert import load_params
from serenade_tpu_torch.models.layers import (
    init_params_,
    store_compute_weights_,
)
from serenade_tpu_torch.models.serenade import Serenade
from serenade_tpu_torch.vocoder.vocoder import Vocoder

SRC_KEYS = ("hubert", "score", "loud")
REF_KEYS = SRC_KEYS + ("logmel",)


class Converter:
    def __init__(self, model_config: Mapping, params, scaler: Mapping, *,
                 vocoder_config: Optional[Mapping] = None,
                 vocoder_params=None, vocoder_stats: Optional[Mapping] = None,
                 n_timesteps: int = 10, solver: str = "euler",
                 temperature: float = 0.667, seed: int = 0, device=None):
        """``vocoder_config`` None converts to mel only.  Runs on CUDA
        unless ``device`` says otherwise."""
        self.device = resolve_device(device)
        # the feature frame rate a server counts audio seconds by
        self.config = dict(FEATURE_CONFIG)
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
        # a server converts from several threads: each noise draw advances
        # the generator atomically (serenade_tpu/api.py ``_next_key``)
        self._noise_lock = threading.Lock()
        self.vocoder = None
        if vocoder_config is not None:
            self.vocoder = Vocoder(
                vocoder_config, vocoder_params, vocoder_stats,
                trg_stats=self.scaler["logmel"], device=self.device,
                seed=seed + 1)

    @property
    def output_sample_rate(self) -> Optional[int]:
        return self.vocoder.sampling_rate if self.vocoder else None

    def _normalize_src(self, feats: Mapping[str, np.ndarray]):
        s = self.scaler

        def minmax(x, st):
            return (x - st["min"]) / (st["max"] - st["min"])

        return {"hubert": (feats["hubert"] - s["hubert"]["mean"])
                / s["hubert"]["scale"],
                "score": minmax(feats["score"], s["score"]),
                "loud": minmax(feats["loud"], s["loud"])}

    def _normalize_ref(self, feats: Mapping[str, np.ndarray]):
        out = self._normalize_src(feats)
        s = self.scaler["logmel"]
        out["logmel"] = (feats["logmel"] - s["mean"]) / s["scale"]
        return out

    def _stack(self, feats_list, keys, T: int) -> Dict[str, torch.Tensor]:
        """Normalized feature dicts -> ``(B, T, C)`` tensors on the device,
        zero-padded to ``T``, and their ``lengths``."""
        def pad(a):
            a = np.asarray(a, np.float32)
            if a.ndim == 1:
                a = a[:, None]
            return pad_to(a, T)

        out = {k: upload(np.stack([pad(f[k]) for f in feats_list]),
                         self.device) for k in keys}
        out["lengths"] = upload(np.asarray(
            [f["hubert"].shape[0] for f in feats_list], np.int32),
            self.device)
        return out

    def _infer(self, src, ref, x0) -> torch.Tensor:
        """``Serenade.inference`` from the noise ``x0`` (already scaled by
        the temperature), drawn here when None."""
        b, ts, _ = src["hubert"].shape
        t = ref["hubert"].shape[1] + ts
        if x0 is None:
            with self._noise_lock:
                x0 = torch.randn((b, t, self.model.output_dim),
                                 generator=self.generator,
                                 dtype=torch.float32, device=self.device)
            x0 = x0 * self.temperature
        else:
            x0 = upload(x0, self.device, np.float32)
        return self.model.inference(
            src["hubert"], src["lengths"], src["score"], src["loud"],
            ref["hubert"], ref["lengths"], ref["logmel"], ref["score"],
            ref["loud"], n_timesteps=self.n_timesteps,
            temperature=self.temperature, solver=self.solver, x0=x0)

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
        mel, (t_src,) = self.convert_features_batch(
            [src_feats], [ref_feats], x0=x0, return_device=True)
        mel = mel[:, :t_src]
        if self.vocoder is None:
            return mel[0].cpu().numpy(), None, None
        wav = self.vocoder.synthesize(mel)[0]
        return (mel[0].cpu().numpy(), wav.cpu().numpy(),
                self.vocoder.sampling_rate)

    def pack_reference(self, ref_feats: Mapping[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
        """One reference normalized, padded to its bucket and placed on the
        device (batch dim 1).  ``convert_features_batch(packed_ref=...)``
        takes it again and again with no upload: a registered style."""
        ref = self._normalize_ref(ref_feats)
        return self._stack([ref], REF_KEYS,
                           bucket_length(ref["hubert"].shape[0]))

    def convert_features_batch(self, src_list, ref_list=None,
                               ts: Optional[int] = None,
                               tr: Optional[int] = None, packed_ref=None,
                               pad_batch_pow2: bool = False,
                               return_device: bool = False,
                               x0: Optional[np.ndarray] = None):
        """Batched conversion: N (src, ref) pairs padded to shared
        ``(ts, tr)`` buckets (the largest of the requests' where not
        given) in one ``Serenade.inference``.  Pass either one reference a
        request in ``ref_list`` or one ``packed_ref`` from
        :meth:`pack_reference` for the whole batch.

        ``pad_batch_pow2`` pads the batch to the next power of two by
        repeating the last request (serving: a few batch shapes per bucket
        pair).  ``x0`` ``(B_padded, tr + ts, mels)`` replaces the noise
        draw, as in :meth:`convert_features`.

        Returns the N mels trimmed to their lengths, or with
        ``return_device`` the ``(B_padded, ts, mels)`` tensor on the device
        and the N lengths.
        """
        b = len(src_list)
        pad = (next_pow2(b) if pad_batch_pow2 else b) - b
        src_list = list(src_list) + [src_list[-1]] * pad
        ts = ts or max(bucket_length(f["hubert"].shape[0]) for f in src_list)
        src = self._stack([self._normalize_src(f) for f in src_list],
                          SRC_KEYS, ts)
        if packed_ref is not None:
            # a real tile: the kernels' wrappers take contiguous operands,
            # and expand() alone would hand them a batch stride of 0
            ref = {k: v.expand(b + pad, *v.shape[1:]).contiguous()
                   for k, v in packed_ref.items()}
        else:
            ref_list = list(ref_list) + [ref_list[-1]] * pad
            tr = tr or max(bucket_length(f["hubert"].shape[0])
                           for f in ref_list)
            ref = self._stack([self._normalize_ref(f) for f in ref_list],
                              REF_KEYS, tr)
        mels = self._infer(src, ref, x0)
        lens = [f["hubert"].shape[0] for f in src_list[:b]]
        if return_device:
            return mels, lens
        host = mels.cpu().numpy()
        return [host[i, :n] for i, n in enumerate(lens)]
