"""Diagnostic plots of mels and F0 tracks (counterpart of
serenade_tpu/utils/plot.py).  matplotlib is imported inside the
functions, with the Agg backend: nothing on a card path imports it, and
the machine with the card does not have it."""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(plt, fig, path: str) -> None:
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_mel(path: str, mel: np.ndarray, title: str = "mel"):
    """One ``(T, n_mels)`` mel as an image, time on x."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 3))
    ax.imshow(np.asarray(mel).T, aspect="auto", origin="lower")
    ax.set_title(title)
    _save(plt, fig, path)


def plot_mel_pair(path: str, gt: np.ndarray, pred: np.ndarray):
    """The ground truth above the prediction."""
    plt = _plt()
    fig, axes = plt.subplots(2, 1, figsize=(10, 6))
    for ax, m, name in zip(axes, (gt, pred), ("ground truth", "prediction")):
        ax.imshow(np.asarray(m).T, aspect="auto", origin="lower")
        ax.set_title(name)
    _save(plt, fig, path)


def plot_f0(path: str, f0_tracks, labels=None):
    """F0 tracks in Hz, unvoiced frames (0) left blank."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 3))
    for i, f0 in enumerate(f0_tracks):
        label = labels[i] if labels else f"track {i}"
        f0 = np.asarray(f0, np.float64).reshape(-1).copy()
        f0[f0 == 0] = np.nan
        ax.plot(f0, label=label)
    ax.set_ylabel("F0 (Hz)")
    ax.legend()
    _save(plt, fig, path)
