#!/usr/bin/env python3
"""Precompute SiFiGAN training streams (counterpart of
serenade_tpu/bin/sifigan_extract_features.py).

Each utterance of a ``wav.scp`` is analysed by the trainer's
``prepare_sifigan_utterance`` (YIN F0 and its median smoothing, the
continuous F0, mel-cepstrum and band aperiodicity, the sine excitation,
the dense dilation factors) and dumped to ``<dumpdir>/<utt>.h5`` with the
keys ``c`` (T, mcep+bap), ``cf0`` (T,), ``sine`` (T*hop, S), ``dfs_<i>``
per upsample level and ``wave`` (T*hop,), so ``bin/vocoder_train.py
--vocoder-type sifigan --sifigan-feats-dir <dir>`` samples segments
without analysing the corpus again.  ``extract_core`` holds the analysis
over ``(utt_id, (audio, fs))`` pairs; ``main`` reads the wavs and writes
the h5s (h5py, imported where it writes).

    python -m serenade_tpu_torch.bin.sifigan_extract_features \\
        --wav-scp wav.scp --dumpdir dump/sifigan [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Iterable, Iterator, Tuple


def extract_core(utterances: Iterable, *, shiftms: float = 5.0,
                 mcep_dim: int = 39, minf0: float = 70.0,
                 maxf0: float = 800.0, dense_factors=(0.5, 1, 4, 8),
                 upsample_scales=(5, 4, 3, 2), device=None
                 ) -> Iterator[Tuple[str, dict]]:
    """``(utt_id, streams)`` for each ``(utt_id, (audio, fs))`` with a
    voiced frame; an utterance without one is logged and skipped."""
    from serenade_tpu_torch.trainers.vocoder_trainer import (
        prepare_sifigan_utterance,
    )

    for utt_id, (audio, fs) in utterances:
        feats = prepare_sifigan_utterance(
            audio, fs, frame_period_ms=shiftms, mcep_dim=mcep_dim,
            f0_floor=minf0, f0_ceil=maxf0,
            dense_factors=tuple(dense_factors),
            upsample_scales=tuple(upsample_scales), device=device)
        if feats is None:
            logging.warning("%s: no voiced frames, skipped", utt_id)
            continue
        yield utt_id, feats


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="precompute SiFiGAN training "
                                "streams")
    p.add_argument("--wav-scp", required=True)
    p.add_argument("--segments", default=None)
    p.add_argument("--dumpdir", required=True)
    p.add_argument("--shiftms", type=float, default=5.0)
    p.add_argument("--mcep-dim", type=int, default=39)
    p.add_argument("--minf0", type=float, default=70.0)
    p.add_argument("--maxf0", type=float, default=800.0)
    p.add_argument("--dense-factors", type=float, nargs="*",
                   default=[0.5, 1, 4, 8])
    p.add_argument("--upsample-scales", type=int, nargs="*",
                   default=[5, 4, 3, 2])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions)")
    p.add_argument("--verbose", type=int, default=1)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: "
               "%(message)s")

    from serenade_tpu_torch.datasets.audio_dataset import AudioSCPDataset
    from serenade_tpu_torch.utils.h5 import write_hdf5

    dataset = AudioSCPDataset(args.wav_scp, segments=args.segments)
    os.makedirs(args.dumpdir, exist_ok=True)
    n_done = 0
    for utt_id, feats in extract_core(
            dataset, shiftms=args.shiftms, mcep_dim=args.mcep_dim,
            minf0=args.minf0, maxf0=args.maxf0,
            dense_factors=args.dense_factors,
            upsample_scales=args.upsample_scales, device=args.device):
        out = os.path.join(args.dumpdir, f"{utt_id}.h5")
        for key, name in (("c", "c"), ("cf0", "cf0"), ("sine", "sine"),
                          ("wav", "wave")):
            write_hdf5(out, name, feats[key])
        for i, d in enumerate(feats["dfs"]):
            write_hdf5(out, f"dfs_{i}", d)
        n_done += 1
        logging.info("dumped %s (%d frames)", utt_id, feats["c"].shape[0])
    logging.info("done: %d dumped, %d skipped", n_done,
                 len(dataset.entries) - n_done)


def load_precomputed(feats_dir: str):
    """The dumps of ``feats_dir`` as the trainer's item dicts."""
    import glob

    import h5py
    import numpy as np

    items = []
    for path in sorted(glob.glob(os.path.join(feats_dir, "*.h5"))):
        with h5py.File(path, "r") as f:
            n_dfs = sum(1 for k in f.keys() if k.startswith("dfs_"))
            items.append({
                "c": np.asarray(f["c"][()], np.float32),
                "cf0": np.asarray(f["cf0"][()], np.float32),
                "sine": np.asarray(f["sine"][()], np.float32),
                "wav": np.asarray(f["wave"][()], np.float32),
                "dfs": [np.asarray(f[f"dfs_{i}"][()], np.float32)
                        for i in range(n_dfs)]})
    return items


if __name__ == "__main__":
    main()
