"""Device-resident training data (counterpart of
serenade_tpu/datasets/device_cache.py ``DeviceResidentData``).

The padded corpus is stacked once into tensors on the card and each step
gathers its batch there by an index tensor, so a step uploads B indices
instead of its features.  Every item pads (or truncates, lengths clamped)
to ``pad_frames_to`` frames.  The corpus carries ``f0_fluc`` when its
first item has it (the F0-fluctuation variant).  Under data parallelism
each rank holds the whole corpus and iterates the global batch's indices
in the same seeded order; the trainer keeps this rank's rows of them
(``parallel.shard_batch``), so each rank gathers only its rows, as JAX's
gather lays its batch out over ``data``.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict

import numpy as np
import torch

from serenade_tpu_torch import resolve_device, upload

logger = logging.getLogger(__name__)


class DeviceResidentData:
    """A dataset stacked on the device, driving a train step by gathers:
    the Serenade batch in f32, as the host collater gives it."""

    FEATURES = {"x": "hubert", "logmel": "logmel", "midi": "score",
                "loud": "loud"}

    def __init__(self, dataset, pad_frames_to: int, batch_size: int,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        t = int(pad_frames_to)
        n = len(dataset)

        def item_at(i):
            item = dataset[i]
            return item[1] if isinstance(item, tuple) else item

        first = item_at(0)
        features = dict(self.FEATURES)
        if "f0_fluc" in first:
            features["f0_fluc"] = "f0_fluc"
        self.arrays = {
            arg: torch.zeros((n, t) + np.asarray(first[key]).shape[1:],
                             dtype=torch.float32, device=self.device)
            for arg, key in features.items()}
        lens = np.zeros(n, np.int32)
        for i in range(n):
            item = item_at(i)
            ln = min(int(item["hubert"].shape[0]), t)
            lens[i] = ln
            for arg, key in features.items():
                row = torch.from_numpy(
                    np.asarray(item[key][:ln], np.float32))
                self.arrays[arg][i, :ln] = row.to(self.device)
        self.lens = torch.from_numpy(lens).to(self.device)
        self.nbytes = sum(a.numel() * a.element_size()
                          for a in self.arrays.values())
        logger.info("device-resident corpus: %d items x %d frames, %.2f GB "
                    "uploaded once", n, t, self.nbytes / 1e9)
        if getattr(dataset, "_cache", None):
            dataset._cache.clear()  # the host copy is now redundant
        self.n = n
        self.batch_size = int(batch_size)
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return self.n // self.batch_size

    def __iter__(self):
        """One epoch of ``{"indices": (B,) int32}`` batches, shuffled by
        ``default_rng((seed, epoch))``; a short last batch is dropped."""
        rng = np.random.default_rng((self.seed, self._epoch))
        self._epoch += 1
        order = rng.permutation(self.n)
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield {"indices": idx.astype(np.int32)}

    def gather(self, indices) -> Dict[str, torch.Tensor]:
        """The batch of the items at ``indices``, gathered on the device."""
        idx = upload(np.asarray(indices, np.int64), self.device)
        out = {k: v.index_select(0, idx) for k, v in self.arrays.items()}
        out["lengths"] = self.lens.index_select(0, idx)
        return out

    def wrap_step(self, step_fn: Callable) -> Callable:
        """``(state, {"indices"}, *rest) -> step_fn(state, batch, *rest)``
        with the batch gathered on the device."""
        def step(state, batch, *rest, **kwargs):
            return step_fn(state, self.gather(batch["indices"]), *rest,
                           **kwargs)

        return step
