"""Batching loader (counterpart of serenade_tpu/datasets/loader.py
``ShardedBatchLoader``).

Each epoch shuffles the index space with ``default_rng(seed + epoch)``,
takes this process's interleaved shard (``process_index::process_count``,
0 and 1 on one card), optionally sorts by length inside windows of
``sort_window`` batches, fetches the items and collates them.  A prefetch
thread runs the reads and the collation while the card computes; the
items can come from a thread pool or from spawned worker processes.
Batches equal the JAX package's, in the same order, epoch after epoch.

Worker processes use the spawn start method (fork is unsafe once CUDA or
threads are up), so the launching script must be importable: build the
loader under ``if __name__ == "__main__"``.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

# --- process-worker plumbing (module level so spawn can pickle it) --------
_WORKER_DATASET = None


def _proc_worker_init(dataset):
    """Runs once in each spawned worker: keep the (cache-stripped)
    dataset, pickled once per worker at pool creation."""
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _proc_worker_get(i: int):
    item = _WORKER_DATASET[int(i)]
    return item[1] if isinstance(item, tuple) else item


class ShardedBatchLoader:
    def __init__(self, dataset, collater: Callable, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 sort_window: int = 0, num_workers: int = 0,
                 worker_type: str = "thread"):
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type must be thread|process, got "
                             f"{worker_type!r}")
        self.dataset = dataset
        self.collater = collater
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.sort_window = sort_window
        self.num_workers = num_workers
        self.worker_type = worker_type
        self.epoch = 0
        self.prefetch = 2  # batches the prefetch thread runs ahead (0: off)
        self._pool = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _shard_size(self) -> int:
        return len(range(self.process_index, len(self.dataset),
                         self.process_count))

    def __len__(self):
        shard = self._shard_size()
        if self.drop_last:
            return shard // self.batch_size
        return (shard + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx[self.process_index::self.process_count]

    def __iter__(self) -> Iterator:
        """One epoch of batches; with ``prefetch > 0`` a background thread
        reads and collates ahead, and its errors surface here."""
        if self.prefetch <= 0:
            yield from self._iter_sync()
            return

        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        errbox = []
        # set when the consumer leaves the epoch early (a trainer stops
        # mid-epoch): the thread then stops instead of blocking on put
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for batch in self._iter_sync():
                    if not put(batch):
                        return
            except BaseException as e:  # noqa: BLE001 — raised below
                errbox.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True,
                             name="ssc-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            t.join()
        if errbox:
            raise errbox[0]

    def _iter_sync(self) -> Iterator:
        if len(self) == 0:
            raise ValueError(
                f"loader would yield zero batches: shard has "
                f"{self._shard_size()} items for batch_size="
                f"{self.batch_size} (drop_last={self.drop_last})")
        idx = self._epoch_indices()
        if self.sort_window > 1:
            # length-sort inside windows of sort_window batches: similar
            # lengths share a batch and its bucket pads less
            if hasattr(self.dataset, "lengths"):
                lengths = np.asarray(
                    self.dataset.lengths())[idx]
            else:
                lengths = np.array([
                    self.dataset[i]["hubert"].shape[0]
                    if isinstance(self.dataset[i], dict) else 0
                    for i in idx])
            chunks = []
            w = self.sort_window * self.batch_size
            for s in range(0, len(idx), w):
                order = np.argsort(lengths[s:s + w])
                chunks.append(idx[s:s + w][order])
            idx = np.concatenate(chunks) if chunks else idx
        for s in range(0, len(idx), self.batch_size):
            chunk = idx[s:s + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            yield self.collater(self._fetch_items(chunk))
        self.epoch += 1

    @staticmethod
    def _strip(items):
        # (utt_id, item) tuples of return_utt_id datasets -> bare items
        return [it[1] if isinstance(it, tuple) else it for it in items]

    def _fetch_items(self, chunk):
        if (self.worker_type == "process" and self.num_workers >= 1
                and len(chunk) > 1):
            return self._fetch_items_proc([int(i) for i in chunk])
        if self.num_workers <= 1 or len(chunk) <= 1:
            return self._strip([self.dataset[int(i)] for i in chunk])
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self.num_workers,
                thread_name_prefix="ssc-loader")
        # map keeps the order; a cache write is a same-value race
        return self._strip(self._pool.map(
            lambda i: self.dataset[int(i)], [int(i) for i in chunk]))

    def _ensure_proc_pool(self):
        if self._pool is None:
            import copy
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            ds = copy.copy(self.dataset)
            if getattr(ds, "_cache", None) is not None:
                ds._cache = None  # workers keep no copy of the cache
            ctx = multiprocessing.get_context("spawn")
            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers, mp_context=ctx,
                initializer=_proc_worker_init, initargs=(ds,))
        return self._pool

    def _fetch_items_proc(self, ids):
        pool = self._ensure_proc_pool()
        cache = getattr(self.dataset, "_cache", None)
        missing = ids if cache is None else [i for i in ids
                                             if i not in cache]
        fetched = (dict(zip(missing, pool.map(_proc_worker_get, missing)))
                   if missing else {})
        out = []
        for i in ids:
            if cache is not None and i in cache:
                out.append(cache[i])
            else:
                if cache is not None:
                    cache[i] = fetched[i]
                out.append(fetched[i])
        return out

    def shutdown(self):
        """Tear down the worker pool (idempotent; the loader goes on
        working, without workers until it needs a pool again)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
