"""Step-driven SSC trainer (counterpart of serenade_tpu/trainers/ssc.py).

A step-counted loop with log, eval and save intervals, tensorboardX
scalars where that package imports, resumable checkpoints (written by
``checkpoint.AsyncSaver`` unless ``async_checkpointing: false``),
intermediate samples on the first dev batch and a ``torch.profiler``
window.  The hot loop is ``batch → train_step`` with the batch uploaded
inside the step; logging, saving and eval run at interval boundaries.

As in the JAX package, a resumed run restores the parameters, moments,
step and epochs, while the random draws restart from the trainer's
``generator`` (seeded anew by the caller) and the loader from its first
epoch: a resumed port run follows a resumed JAX run.

Under a parallel layout (the state's ``layout``, ``parallel/sharding.py``)
every rank reads the global batch in the same seeded order and keeps its
rows (``parallel.shard_batch``); only rank 0 logs, evaluates and writes
samples and checkpoints, and every rank reaches a save and an eval, whose
gathers of the shards are collectives.  A checkpoint holds the one-card
layout and restores onto any layout.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from serenade_tpu_torch.checkpoint import (
    AsyncSaver, find_latest_checkpoint, restore_checkpoint, save_checkpoint,
)

logger = logging.getLogger(__name__)


def _fetch(metrics: Dict[str, Any]) -> Dict[str, float]:
    """A step's metrics on the host, in one device round trip."""
    names = list(metrics)
    values = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32)
                          for k in names]).tolist()
    return dict(zip(names, values))


def _check_like(restored, live, what: str) -> None:
    """Raise unless ``restored`` has ``live``'s structure: the same keys,
    and tensors of the same shapes and dtypes."""
    if isinstance(live, dict):
        if not isinstance(restored, dict):
            raise ValueError(f"{what}: checkpoint holds "
                             f"{type(restored).__name__}, not a dict")
        differ = set(live) ^ set(restored)
        if differ:
            raise ValueError(f"{what}: checkpoint keys differ from the live "
                             f"state's at {sorted(map(str, differ))[:5]}")
        for k in live:
            _check_like(restored[k], live[k], f"{what}/{k}")
    elif torch.is_tensor(live):
        if not torch.is_tensor(restored) or (
                restored.shape, restored.dtype) != (live.shape, live.dtype):
            raise ValueError(
                f"{what}: checkpoint holds "
                f"{getattr(restored, 'shape', None)} "
                f"{getattr(restored, 'dtype', type(restored).__name__)}, "
                f"the live state {live.shape} {live.dtype}")


@torch.no_grad()
def _copy_into(live, restored):
    """Copy a restored tree into the live one in place; returns the live
    tree with its non-tensor leaves (the optimizer's count) replaced."""
    if isinstance(live, dict):
        for k in live:
            live[k] = _copy_into(live[k], restored[k])
        return live
    if torch.is_tensor(live):
        live.copy_(restored)
        return live
    return restored


class SSCTrainer:
    """Drives a train step (``trainers.build_train_step``) to
    ``train_max_steps``."""

    # f0_flucs: the F0-fluctuation variant's collater only
    BATCH_RENAME = {"xs": "x", "ys": "logmel", "scores": "midi",
                    "louds": "loud", "lens": "lengths",
                    "f0_flucs": "f0_fluc"}

    def __init__(self, config: Dict[str, Any], train_step: Callable, state,
                 train_iter: Iterable, writer=None, outdir: str = "exp",
                 eval_fn: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        """``generator`` (on the step's device) draws every step's
        segments, flow times, noise and dropout; the CLI seeds it from
        ``seed + 2``, where the JAX package seeds its key chain."""
        self.config = config
        self.train_step = train_step
        self.state = state
        self.train_iter = train_iter
        self.outdir = outdir
        self.eval_fn = eval_fn
        self.generator = generator
        self.steps = int(state.step)
        self.epochs = 0
        self.finish_train = False
        self.total_train_loss = defaultdict(float)
        self._pending = []
        self._n_acc = 0  # metrics accumulated since the last log boundary
        self.layout = getattr(state, "layout", None)
        self.main = self.layout is None or self.layout.writer
        # how many steps the host may run ahead of the device before it
        # fetches the OLDEST pending metrics (a bound on queued batches)
        self._dispatch_window = int(config.get("dispatch_window", 32))
        self._writer = writer
        self._last_log_time = time.time()
        self.profile_dir = config.get("profile_dir")
        self.profile_steps = tuple(config.get("profile_steps", (10, 15)))
        self._profiler = None
        self._saver = (AsyncSaver() if config.get("async_checkpointing", True)
                       and self.main else None)
        self._last_saved_step = -1
        # step -> seconds the loop spent in save() (the snapshot's set-up
        # for an async save, the whole write for a synchronous one)
        self.save_blocked_s: Dict[int, float] = {}

        if writer is None and self.main:
            try:
                from tensorboardX import SummaryWriter

                self._writer = SummaryWriter(outdir)
            except Exception:  # noqa: BLE001 — scalars are then only logged
                self._writer = None

    # ------------------------------------------------------------------

    def run(self):
        max_steps = int(self.config.get("train_max_steps", 40000))
        if self.main:
            logger.info("training from step %d to %d", self.steps,
                        max_steps)
        try:
            while not self.finish_train:
                self._train_epoch(max_steps)
                self.epochs += 1
        finally:
            if self._profiler is not None:   # the stop step never came
                self._stop_profile()
            if self._last_saved_step != self.steps:
                # not when the interval save already wrote this step
                self.save(self.steps)
            self.wait_for_saves()
        if self.main:
            logger.info("finished training at step %d", self.steps)

    def _prep_batch(self, batch):
        batch = {self.BATCH_RENAME.get(k, k): v for k, v in batch.items()}
        if self.layout is not None and self.layout.data_size > 1:
            from serenade_tpu_torch.parallel import shard_batch

            batch = shard_batch(batch, self.layout.mesh)
        return batch

    def _stop_profile(self):
        self._profiler.__exit__(None, None, None)
        start, stop = self.profile_steps
        path = os.path.join(self.profile_dir,
                            f"trace_steps{start}-{stop}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        logger.info("profiler trace written to %s", path)

    def _maybe_profile(self):
        if not self.profile_dir:
            return
        start, stop = self.profile_steps
        if self.steps == start and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.profile_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.__enter__()
            logger.info("profiler trace started (steps %d-%d)", start, stop)
        elif self.steps >= stop and self._profiler is not None:
            self._stop_profile()

    def _train_epoch(self, max_steps: int):
        for batch in self.train_iter:
            self._maybe_profile()
            self.state, metrics = self.train_step(
                self.state, self._prep_batch(batch), self.generator)
            self.steps += 1
            if self.steps == 1 and self.main:
                # the first step's loss on the host: proof that it ran
                logger.info("first step executed: train/loss = %.4f",
                            float(metrics["train/loss"]))
            self._accumulate(metrics)
            self._check_log_interval()
            self._check_eval_interval()
            self._check_save_interval()
            if self.steps >= max_steps:
                self.finish_train = True
                return

    def _accumulate(self, metrics):
        # hold the device scalars unfetched so no step waits for its own
        # metrics, but fetch the OLDEST once the window fills
        self._pending.append(metrics)
        self._n_acc += 1
        while len(self._pending) >= self._dispatch_window:
            for k, v in _fetch(self._pending.pop(0)).items():
                self.total_train_loss[k] += v

    # ------------------------------------------------------------------
    # intervals
    # ------------------------------------------------------------------

    def _check_log_interval(self):
        interval = int(self.config.get("log_interval_steps", 500))
        if self.steps % interval:
            return
        # divide by the count accumulated: after a resume from a
        # mid-interval checkpoint the first window is shorter
        n_acc = self._n_acc
        for m in self._pending:
            for k, v in _fetch(m).items():
                self.total_train_loss[k] += v
        self._pending = []
        self._n_acc = 0
        elapsed = time.time() - self._last_log_time
        self._last_log_time = time.time()
        for key, total in self.total_train_loss.items():
            avg = total / max(n_acc, 1)
            if self.main:
                logger.info("(steps: %d) %s = %.4f", self.steps, key, avg)
            if self._writer is not None:
                self._writer.add_scalar(key, avg, self.steps)
        if self._writer is not None:
            self._writer.add_scalar("train/steps_per_sec",
                                    interval / max(elapsed, 1e-9),
                                    self.steps)
        self.total_train_loss = defaultdict(float)

    def _check_eval_interval(self):
        interval = int(self.config.get("eval_interval_steps", 2500))
        if self.steps % interval or self.eval_fn is None:
            return
        # every rank gathers the tp shards; rank 0 converts and writes
        with (self.layout.materialized() if self.layout is not None
              else contextlib.nullcontext()):
            if not self.main:
                return
            try:
                self.eval_fn(self.state, self.steps)
            except Exception:  # noqa: BLE001 — eval must never stop training
                logger.exception("intermediate eval failed at step %d",
                                 self.steps)

    def _check_save_interval(self):
        interval = int(self.config.get("save_interval_steps", 2500))
        if self.steps % interval:
            return
        self.save(self.steps)

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def save(self, step: int):
        t0 = time.time()
        params = {k: p.detach() for k, p in self.state.params.items()}
        opt_state = self.state.opt_state
        if self.layout is not None:
            # the one-card layout, gathered by every rank; rank 0 writes
            params = self.layout.full_params(params)
            opt_state = self.layout.full_opt_state(opt_state)
        self._last_saved_step = step
        if not self.main:
            return
        if self._saver is not None:
            path = self._saver.save(self.outdir, step, params, opt_state,
                                    epochs=self.epochs)
        else:
            path = save_checkpoint(self.outdir, step, params, opt_state,
                                   epochs=self.epochs)
        self.save_blocked_s[step] = time.time() - t0
        logger.info("saved checkpoint: %s (%s, step blocked %.3fs)", path,
                    "async commit" if self._saver is not None else "sync",
                    self.save_blocked_s[step])

    def wait_for_saves(self):
        """Block until every async save is on disk (a no-op for
        synchronous saves)."""
        if self._saver is not None:
            self._saver.wait()

    def resume(self, path: Optional[str] = None,
               load_only_params: bool = False):
        """Restore ``path`` (else the latest checkpoint under ``outdir``)
        into the live state in place, its structure checked against the
        live one: parameters, and unless ``load_only_params`` the
        optimizer state, step and epochs."""
        path = path or find_latest_checkpoint(self.outdir)
        if path is None:
            logger.info("no checkpoint found; starting fresh")
            return
        restored = restore_checkpoint(path)
        if self.layout is not None:
            # this rank's shards of the one-card layout
            restored["params"] = self.layout.local_params(restored["params"])
            if "opt_state" in restored and not load_only_params:
                restored["opt_state"] = self.layout.local_opt_state(
                    restored["opt_state"])
        live = {k: p.data for k, p in self.state.params.items()}
        _check_like(restored["params"], live, "params")
        if not load_only_params:
            if "opt_state" not in restored:
                raise ValueError(f"{path} holds no optimizer state; resume "
                                 "with load_only_params")
            _check_like(restored["opt_state"], self.state.opt_state,
                        "opt_state")
        _copy_into(live, restored["params"])
        if not load_only_params:
            _copy_into(self.state.opt_state, restored["opt_state"])
            self.steps = int(restored["meta"]["step"])
            self.epochs = int(restored["meta"].get("epochs", 0))
            self.state.step = self.steps
        if self.main:
            logger.info("restored checkpoint %s (steps=%d)", path,
                        self.steps)


class SSCTrainerNew(SSCTrainer):
    """The F0-fluctuation variant's trainer: ``SSCTrainer`` itself, whose
    ``BATCH_RENAME`` maps ``f0_flucs`` too; a name of the registry."""
