"""Intermediate samples during training (counterpart of
serenade_tpu/trainers/eval_samples.py).

Every eval interval the first dev batch is converted with itself as its
own reference (Euler-10, noise from a generator seeded by the step), and the
first ``num_save`` rows are written under
``<outdir>/predictions/<steps>steps/``: a mel plot against the ground
truth where matplotlib imports, and the vocoded prediction and ground
truth as wavs where a vocoder is given.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from serenade_tpu_torch import resolve_device
from serenade_tpu_torch.trainers.ssc import SSCTrainer
from serenade_tpu_torch.trainers.train_step import to_device

logger = logging.getLogger(__name__)


def make_eval_fn(model, dev_batch, *, outdir: str, vocoder=None,
                 num_save: int = 8, device=None):
    """An ``eval_fn(state, steps)`` for ``SSCTrainer``; ``model`` is the
    live model the state's parameters belong to.  ``vocoder``: a
    ``vocoder.Vocoder`` whose ``trg_stats`` are the logmel scaler's.  A
    batch with the F0 fluctuation gives it as the source's and the
    reference's."""
    dev = resolve_device(device)
    rename = SSCTrainer.BATCH_RENAME
    batch = {rename.get(k, k): to_device(v, dev)
             for k, v in dev_batch.items()}
    lengths = batch["lengths"].cpu().numpy()
    logmel = batch["logmel"].float().cpu().numpy()

    def eval_fn(state, steps: int):
        b = batch
        gen = torch.Generator(device=dev).manual_seed(int(steps))
        src = [b["x"], b["lengths"], b["midi"], b["loud"]]
        ref = [b["x"], b["lengths"], b["logmel"], b["midi"], b["loud"]]
        if "f0_fluc" in b:
            src.append(b["f0_fluc"])
            ref.append(b["f0_fluc"])
        out = model.inference(*src, *ref, generator=gen, n_timesteps=10)
        mel_pred = out.float().cpu().numpy()
        dirname = os.path.join(outdir, "predictions", f"{steps}steps")
        os.makedirs(dirname, exist_ok=True)
        n = min(num_save, mel_pred.shape[0])
        for i in range(n):
            T = int(lengths[i])
            pred, gt = mel_pred[i, :T], logmel[i, :T]
            _save_mel_plot(os.path.join(dirname, f"sample{i}_mel.png"),
                           pred, gt)
            if vocoder is not None:
                try:
                    from serenade_tpu_torch.utils.audio import write_wav

                    y, sr = vocoder.decode(pred)
                    write_wav(os.path.join(dirname, f"sample{i}_gen.wav"),
                              y, sr)
                    y_gt, sr = vocoder.decode(gt)
                    write_wav(os.path.join(dirname, f"sample{i}_gt.wav"),
                              y_gt, sr)
                except Exception:  # noqa: BLE001 — the mel is still written
                    logger.exception("vocoding eval sample failed")
        logger.info("wrote %d eval samples to %s", n, dirname)
        return mel_pred

    return eval_fn


def _save_mel_plot(path: str, pred: np.ndarray, gt: np.ndarray):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # noqa: BLE001 — no plot without matplotlib
        return
    fig, axes = plt.subplots(2, 1, figsize=(10, 6))
    axes[0].imshow(gt.T, aspect="auto", origin="lower")
    axes[0].set_title("ground truth")
    axes[1].imshow(pred.T, aspect="auto", origin="lower")
    axes[1].set_title("prediction")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
