"""Feature scalers and the statistics files that hold them.

``StandardScaler`` and ``MinMaxScaler`` are copied from
serenade_tpu/utils/scalers.py: numpy equivalents of sklearn's, with its
attribute names (``mean_``, ``scale_``, ``var_``, ``data_min_``,
``data_max_``).  A ``stats.joblib`` pickles them under the JAX package's
class paths (serenade_tpu/bin/compute_statistics.py) or, from the
upstream recipe, under sklearn's; :func:`load_scalers` maps both onto the
classes here, so loading one imports neither package.  Reading a joblib
file needs ``joblib``, imported when one is read.
"""

from __future__ import annotations

import inspect
import pickle

import numpy as np


class StandardScaler:
    """Z-normalization with Chan et al. parallel-variance streaming updates
    (numerically matches sklearn's partial_fit)."""

    def __init__(self):
        self.n_samples_seen_ = 0
        self.mean_ = None
        self.var_ = None
        self.scale_ = None

    def partial_fit(self, X):
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X[:, None]
        n = X.shape[0]
        if n == 0:
            return self
        batch_mean = X.mean(axis=0)
        batch_var = X.var(axis=0)
        if self.n_samples_seen_ == 0:
            self.mean_ = batch_mean
            self.var_ = batch_var
            self.n_samples_seen_ = n
        else:
            m = self.n_samples_seen_
            total = m + n
            delta = batch_mean - self.mean_
            new_mean = self.mean_ + delta * n / total
            # combine M2 moments (Chan parallel algorithm)
            m2 = self.var_ * m + batch_var * n + delta**2 * m * n / total
            self.mean_ = new_mean
            self.var_ = m2 / total
            self.n_samples_seen_ = total
        self.scale_ = np.sqrt(np.where(self.var_ == 0.0, 1.0, self.var_))
        return self

    def fit(self, X):
        self.n_samples_seen_ = 0
        return self.partial_fit(X)

    def transform(self, X):
        X = np.asarray(X)
        return (X - self.mean_) / self.scale_

    def inverse_transform(self, X):
        X = np.asarray(X)
        return X * self.scale_ + self.mean_


class MinMaxScaler:
    """Min-max scaling to ``feature_range`` with sklearn attribute names."""

    def __init__(self, feature_range=(0.0, 1.0)):
        self.feature_range = feature_range
        self.n_samples_seen_ = 0
        self.data_min_ = None
        self.data_max_ = None
        self.scale_ = None
        self.min_ = None

    def partial_fit(self, X):
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X[:, None]
        if X.shape[0] == 0:
            return self
        batch_min = X.min(axis=0)
        batch_max = X.max(axis=0)
        if self.n_samples_seen_ == 0:
            self.data_min_ = batch_min
            self.data_max_ = batch_max
        else:
            self.data_min_ = np.minimum(self.data_min_, batch_min)
            self.data_max_ = np.maximum(self.data_max_, batch_max)
        self.n_samples_seen_ += X.shape[0]
        lo, hi = self.feature_range
        rng = self.data_max_ - self.data_min_
        rng = np.where(rng == 0.0, 1.0, rng)
        self.scale_ = (hi - lo) / rng
        self.min_ = lo - self.data_min_ * self.scale_
        return self

    def fit(self, X):
        self.n_samples_seen_ = 0
        return self.partial_fit(X)

    def transform(self, X):
        X = np.asarray(X)
        return X * self.scale_ + self.min_

    def inverse_transform(self, X):
        X = np.asarray(X)
        return (X - self.min_) / self.scale_


# the class paths a stats.joblib may name for each scaler: the JAX
# package's, and sklearn's (``preprocessing.data`` before sklearn 0.22)
_SCALERS = {"StandardScaler": StandardScaler, "MinMaxScaler": MinMaxScaler}
_SCALER_MODULES = ("serenade_tpu.utils.scalers",
                   "sklearn.preprocessing._data", "sklearn.preprocessing.data")
_REFUSED_ROOTS = ("serenade_tpu", "sklearn")


def _mapped_class(module: str, name: str):
    """The port's class for a scaler class path, None for a path outside
    the JAX package and sklearn; raises for any other class of those two,
    which unpickling would import."""
    if module in _SCALER_MODULES and name in _SCALERS:
        return _SCALERS[name]
    if module.split(".")[0] in _REFUSED_ROOTS:
        raise pickle.UnpicklingError(
            f"{module}.{name} is not a scaler this reader maps; it would "
            f"import {module.split('.')[0]}")
    return None


def load_scalers(path: str) -> dict:
    """The fitted scalers of a ``stats.joblib`` (``{"hubert", "logmel",
    "score", "loud"}``), as written by ``joblib.dump`` without compression,
    their classes mapped onto this module's."""
    try:
        from joblib import numpy_pickle
    except ImportError as exc:
        raise ImportError(f"reading {path} needs the joblib package") from exc

    class _Unpickler(numpy_pickle.NumpyUnpickler):
        def find_class(self, module, name):
            return (_mapped_class(module, name)
                    or super().find_class(module, name))

    params = inspect.signature(numpy_pickle.NumpyUnpickler).parameters
    kwargs = ({"ensure_native_byte_order": True}
              if "ensure_native_byte_order" in params else {})
    with open(path, "rb") as fh:
        if fh.read(1) != pickle.PROTO:
            raise ValueError(f"{path} is not an uncompressed joblib pickle")
        fh.seek(0)
        return _Unpickler(path, fh, **kwargs).load()


# the Converter's statistics: per feature, the two arrays it reads
STATS_KEYS = {"hubert": ("mean", "scale"), "score": ("min", "max"),
              "loud": ("min", "max"), "logmel": ("mean", "scale")}


def scaler_dicts(scalers) -> dict:
    """Fitted scalers -> the ``{"mean", "scale"}`` / ``{"min", "max"}``
    arrays per feature that ``api.Converter`` takes."""
    attrs = {"mean": "mean_", "scale": "scale_", "min": "data_min_",
             "max": "data_max_"}
    return {feat: {stat: np.asarray(getattr(scalers[feat], attrs[stat]))
                   for stat in stats} for feat, stats in STATS_KEYS.items()}


def load_stats(path: str) -> dict:
    """The Converter's statistics from a ``stats.joblib`` of fitted
    scalers, or from an ``.npz`` of ``<feature>_<stat>`` arrays
    (``hubert_mean``, ``hubert_scale``, ``score_min``, ``score_max``,
    ``loud_min``, ``loud_max``, ``logmel_mean``, ``logmel_scale``)."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            return {feat: {stat: z[f"{feat}_{stat}"] for stat in stats}
                    for feat, stats in STATS_KEYS.items()}
    return scaler_dicts(load_scalers(path))
