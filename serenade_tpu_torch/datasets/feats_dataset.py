"""Feature-dump dataset over per-utterance h5 files (counterpart of
serenade_tpu/datasets/feats_dataset.py ``FeatsDataset``).

Finds the ``*.h5`` dumps under a directory and reads the feature streams.
Items are numpy dicts with the JAX package's keys.  With ``scaler`` (the
fitted scalers of a ``stats.joblib``, ``utils.scalers.load_scalers``) the
items are normalized in f32 as training reads them: z-norm for hubert and
logmel, min-max for score and loud; without it they stay as dumped (the
decode's Converter normalizes them).  ``FeatsDatasetNew`` adds the
F0-fluctuation stream ``f0_fluc``, read as dumped (never scaled).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np

from serenade_tpu_torch.utils.h5 import (
    dataset_shape, find_files, read_hdf5, read_hdf5_many,
)

logger = logging.getLogger(__name__)


def _as_2d(x):
    x = np.asarray(x)
    return x[:, None] if x.ndim == 1 else x


class FeatsDataset:
    KEYS = ("wave", "hubert", "logmel", "score", "midi", "loud", "lf0")
    # item key -> h5 dataset name (score and logmel follow their types)
    _H5_NAMES = {"wave": "wave", "hubert": "hubert", "midi": "midi",
                 "loud": "loud", "lf0": "f0"}

    def __init__(self, root_dir: str, scaler=None,
                 score_type: str = "est_lf0_score",
                 logmel_type: str = "logmel", return_utt_id: bool = False,
                 query: str = "*.h5", allow_cache: bool = False,
                 logmel_fallback: bool = False, load_keys=None):
        """``load_keys``: read only these item keys (the training collater
        takes hubert, logmel, score and loud); None reads all.
        ``allow_cache`` keeps each item after its first read.
        ``logmel_fallback``: a dump without the ``logmel_type`` dataset
        (an original dev dump under the cyclic recipe's
        ``cyclic_logmel``) gives its own ``logmel``; off, it raises."""
        self.files = sorted(find_files(root_dir, query))
        if not self.files:
            raise ValueError(f"no {query} files under {root_dir}")
        self.utt_ids = [os.path.splitext(os.path.basename(f))[0]
                        for f in self.files]
        self.scaler = scaler
        self.score_type = score_type
        self.logmel_type = logmel_type
        self.return_utt_id = return_utt_id
        self.logmel_fallback = logmel_fallback
        self.load_keys = tuple(load_keys) if load_keys else None
        self._cache: Optional[Dict[int, dict]] = {} if allow_cache else None
        self._lengths: Dict[str, np.ndarray] = {}

    def __len__(self):
        return len(self.files)

    def _h5_name(self, key: str) -> str:
        if key == "logmel":
            return self.logmel_type
        if key == "score":
            return self.score_type
        return self._H5_NAMES.get(key, key)

    def lengths(self, key: str = "hubert"):
        """Frame count per utterance from the h5 headers (no data read),
        cached per key."""
        name = self._h5_name(key)
        if name not in self._lengths:
            out = np.empty(len(self.files), np.int64)
            for i, f in enumerate(self.files):
                shape = dataset_shape(f, name)
                if shape is None:
                    raise KeyError(f"{f} has no {name!r} dataset")
                out[i] = shape[0]
            self._lengths[name] = out
        return self._lengths[name]

    def _load(self, path: str) -> dict:
        wanted = self.load_keys or self.KEYS
        raw = read_hdf5_many(path, tuple({self._h5_name(k) for k in wanted}))
        if "logmel" in wanted and raw[self.logmel_type] is None:
            if self.logmel_fallback and self.logmel_type != "logmel":
                raw[self.logmel_type] = read_hdf5(path, "logmel")
            if raw[self.logmel_type] is None:
                raise KeyError(
                    f"{path} has no {self.logmel_type!r} dataset"
                    + (" (stage-6 cyclic_logmel injection missing?)"
                       if self.logmel_type != "logmel" else ""))
        item = {k: np.asarray(raw["wave"]) if k == "wave"
                else _as_2d(raw[self._h5_name(k)])
                for k in self.KEYS if k in wanted}
        if self.scaler is not None:
            s = self.scaler
            # in place on the fresh reads, in f32
            for k in ("logmel", "hubert"):
                if k in item:
                    v = np.asarray(item[k], np.float32)
                    v -= s[k].mean_
                    v /= s[k].scale_
                    item[k] = v
            for k in ("score", "loud"):
                if k in item:
                    v = np.asarray(item[k], np.float32)
                    v -= s[k].data_min_
                    v /= (s[k].data_max_ - s[k].data_min_)
                    item[k] = v
            if "logmel" in item and np.isnan(item["logmel"]).any():
                logger.info("contains nan: %s", path)
        return item

    def __getitem__(self, idx: int):
        if self._cache is not None and idx in self._cache:
            item = self._cache[idx]
        else:
            item = self._load(self.files[idx])
            if self._cache is not None:
                self._cache[idx] = item
        if self.return_utt_id:
            return self.utt_ids[idx], item
        return item


class FeatsDatasetNew(FeatsDataset):
    """Adds the F0-fluctuation stream, unscaled and 2-D ``(T, 1)``."""

    KEYS = FeatsDataset.KEYS + ("f0_fluc",)

    def _load(self, path: str) -> dict:
        item = super()._load(path)
        if "f0_fluc" in item and item["f0_fluc"].ndim != 2:   # not dumped
            raise KeyError(f"{path} has no 'f0_fluc' dataset (dump it "
                           "with preprocess_new)")
        return item
