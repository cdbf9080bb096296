"""HDF5 / npy dump I/O and Kaldi-style scp loaders (counterpart of
serenade_tpu/utils/h5.py).

Feature dumps hold one ``.h5`` per utterance with named datasets
(``wave``, ``hubert``, ``logmel``, ``loud``, ``gt_lf0_score``,
``est_lf0_score``, ``f0``, ``vuv``, ``midi``).  ``h5py`` is imported when
a file is read or written, so the module imports without it.
"""

from __future__ import annotations

import fnmatch
import logging
import os
from typing import Dict, Iterator

import numpy as np

logger = logging.getLogger(__name__)


def _h5py():
    try:
        import h5py
    except ImportError as exc:
        raise ImportError("reading or writing h5 dumps needs the h5py "
                          "package") from exc
    return h5py


def find_files(root_dir: str, query: str = "*.wav",
               include_root_dir: bool = True):
    """Recursively find files matching ``query`` under ``root_dir``."""
    found = []
    for root, _, filenames in os.walk(root_dir, followlinks=True):
        for filename in fnmatch.filter(filenames, query):
            found.append(os.path.join(root, filename))
    if not include_root_dir:
        prefix = root_dir.rstrip("/") + "/"
        found = [f[len(prefix):] if f.startswith(prefix) else f
                 for f in found]
    return found


def read_hdf5(path: str, dataset: str):
    """Read one dataset from an hdf5 file; None on a missing file or key."""
    if not os.path.exists(path):
        logger.error("no such hdf5 file: %s", path)
        return None
    with _h5py().File(path, "r") as f:
        if dataset not in f:
            logger.error("no dataset %r in %s", dataset, path)
            return None
        return f[dataset][()]


def read_hdf5_many(path: str, datasets) -> Dict[str, np.ndarray]:
    """Several datasets in one file open; a missing key maps to None."""
    if not os.path.exists(path):
        logger.error("no such hdf5 file: %s", path)
        return {name: None for name in datasets}
    with _h5py().File(path, "r") as f:
        return {name: f[name][()] if name in f else None
                for name in datasets}


def dataset_shape(path: str, name: str):
    """Shape of one dataset, read from its header; None when the file or
    the dataset is missing."""
    if not os.path.exists(path):
        return None
    with _h5py().File(path, "r") as f:
        return f[name].shape if name in f else None


def hdf5_has(path: str, dataset: str) -> bool:
    """True iff ``path`` exists and holds ``dataset``."""
    if not os.path.exists(path):
        return False
    with _h5py().File(path, "r") as f:
        return dataset in f


def write_hdf5(path: str, dataset: str, data,
               is_overwrite: bool = True) -> None:
    """Write one dataset into an hdf5 file, creating parent dirs as needed;
    an existing dataset is replaced when ``is_overwrite``, else refused."""
    data = np.asarray(data)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    mode = "r+" if os.path.exists(path) else "w"
    with _h5py().File(path, mode) as f:
        if dataset in f:
            if not is_overwrite:
                raise FileExistsError(
                    f"dataset {dataset!r} already exists in {path}")
            del f[dataset]
        f.create_dataset(dataset, data=data)


class _ScpLoader:
    """Base: parse a 2-column ``key path`` scp file."""

    def __init__(self, scp_path: str):
        self.data: Dict[str, str] = {}
        with open(scp_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                key, value = line.split(maxsplit=1)
                self.data[key] = value

    def get_path(self, key: str) -> str:
        return self.data[key]

    def __len__(self) -> int:
        return len(self.data)

    def __iter__(self) -> Iterator[str]:
        return iter(self.data)

    def keys(self):
        return self.data.keys()

    def values(self):
        for key in self.keys():
            yield self[key]

    def __getitem__(self, key: str):  # pragma: no cover - abstract
        raise NotImplementedError


class HDF5ScpLoader(_ScpLoader):
    """hdf5-backed feats.scp: ``key path.h5`` (reads
    ``default_hdf5_path``), ``key path.h5:name``, or ``key
    path.h5:name1,name2`` (concatenated on the feature axis, 1-D entries
    as columns)."""

    def __init__(self, scp_path: str, default_hdf5_path: str = "feats"):
        super().__init__(scp_path)
        self.default_hdf5_path = default_hdf5_path

    def __getitem__(self, key: str):
        entry = self.data[key]
        if ":" not in entry:
            return read_hdf5(entry, self.default_hdf5_path)
        path, names = entry.split(":")
        parts = names.split(",")
        if len(parts) == 1:
            return read_hdf5(path, parts[0])
        feats = [read_hdf5(path, name) for name in parts]
        feats = [f.reshape(-1, 1) if f.ndim == 1 else f for f in feats]
        return np.concatenate(feats, axis=1)


class NpyScpLoader(_ScpLoader):
    """npy-backed feats.scp (``key path.npy`` lines)."""

    def __getitem__(self, key: str):
        return np.load(self.data[key])


def sniff_feats_scp_loader(scp_path: str, default_hdf5_path: str = "feats"):
    """HDF5 or npy loader, by the extension of the first entry."""
    with open(scp_path) as f:
        first = f.readline().split()
    if len(first) < 2:
        raise ValueError(f"empty or malformed scp: {scp_path}")
    value = first[1]
    base = value.split(":")[0]
    if base.endswith(".h5") or base.endswith(".hdf5"):
        return HDF5ScpLoader(scp_path, default_hdf5_path)
    if base.endswith(".npy"):
        return NpyScpLoader(scp_path)
    raise ValueError(f"unsupported feats file format in scp: {value}")
