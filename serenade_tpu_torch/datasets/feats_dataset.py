"""Feature-dump dataset over per-utterance h5 files (counterpart of
serenade_tpu/datasets/feats_dataset.py ``FeatsDataset``).

Finds the ``*.h5`` dumps under a directory and reads the feature streams
as dumped (the Converter normalizes them).  Items are numpy dicts with the
same keys.  The training loader's options (``scaler``, ``load_keys``,
``allow_cache``, ``logmel_fallback``) and the F0-fluctuation variant
(``FeatsDatasetNew``) are not ported.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from serenade_tpu_torch.utils.h5 import (
    dataset_shape, find_files, read_hdf5_many,
)


def _as_2d(x):
    x = np.asarray(x)
    return x[:, None] if x.ndim == 1 else x


class FeatsDataset:
    KEYS = ("wave", "hubert", "logmel", "score", "midi", "loud", "lf0")
    # item key -> h5 dataset name (score and logmel follow their types)
    _H5_NAMES = {"wave": "wave", "hubert": "hubert", "midi": "midi",
                 "loud": "loud", "lf0": "f0"}

    def __init__(self, root_dir: str, score_type: str = "est_lf0_score",
                 logmel_type: str = "logmel", return_utt_id: bool = False):
        self.files = sorted(find_files(root_dir, "*.h5"))
        if not self.files:
            raise ValueError(f"no *.h5 files under {root_dir}")
        self.utt_ids = [os.path.splitext(os.path.basename(f))[0]
                        for f in self.files]
        self.score_type = score_type
        self.logmel_type = logmel_type
        self.return_utt_id = return_utt_id
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
        raw = read_hdf5_many(path, tuple(self._h5_name(k) for k in self.KEYS))
        if raw[self.logmel_type] is None:
            raise KeyError(f"{path} has no {self.logmel_type!r} dataset")
        return {k: np.asarray(raw[self._h5_name(k)]) if k == "wave"
                else _as_2d(raw[self._h5_name(k)]) for k in self.KEYS}

    def __getitem__(self, idx: int):
        item = self._load(self.files[idx])
        if self.return_utt_id:
            return self.utt_ids[idx], item
        return item
