"""The preprocessing CLI, ``wav.scp`` -> per-utterance h5 dumps
(counterpart of serenade_tpu/bin/preprocess.py)::

    python -m serenade_tpu_torch.bin.preprocess --wav-scp data/train/wav.scp \
        --dumpdir dump/train --config conf/serenade.yaml \
        --f0-path conf/f0.yaml --contentvec-ckpt content-vec-best.pt

The JAX CLI's flags and dump contract (``wave``, ``hubert``, ``logmel``,
``loud``, ``gt_lf0_score``, ``est_lf0_score``, ``f0``, ``vuv``, ``midi``;
``bin/preprocess_new.py`` adds ``f0_fluc``): the utterances of a window
are extracted in batches (``features.extract_features_batch``) on the
card unless ``--device cpu``.  ``--contentvec-ckpt`` is a ``.pt`` Hugging
Face ``HubertModel`` state dict; without it, ``--allow-missing-hubert
true`` dumps everything but ``hubert``.  ``--f0-backend jax`` is plain
YIN, ``harvest`` Harvest on the device, ``native`` and ``harvest_native``
YIN and Harvest on the host (``native.py``); ``--midi-model-ckpt`` (an
upstream ``midi_model.pt``) takes the estimated score from the
phoneme-MIDI transcriber (``modules/phoneme_midi``) in place of F0 note
segmentation.  Needs pyyaml for the config and the F0 table, and h5py for
the dumps.

The module also holds ``make_content_fn``, the content function that
feature extraction and the raw-audio serving path call.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from serenade_tpu_torch import resolve_device, upload
from serenade_tpu_torch.collaters.ssc import next_pow2
from serenade_tpu_torch.configs import CONTENTVEC_CONFIG
from serenade_tpu_torch.modules.contentvec import (
    ContentVecEncoder, load_contentvec_params,
)
from serenade_tpu_torch.ops.resample import resample_device
from serenade_tpu_torch.utils.types import str2bool

BUCKET_16K = 32000   # 2 s at 16 kHz: one batch shape per bucket
BUCKET_24K = 48000   # the same 2 s at 24 kHz, which the 2/3 resample maps
                     # onto BUCKET_16K exactly


def _frames(n16: int) -> int:
    """ContentVec frames of ``n16`` 16 kHz samples (the conv stack's
    receptive field), at least 1."""
    return max((n16 - 400) // 160 + 1, 1)


def make_content_fn(ckpt=None, batch_size: int = 8, *, config=None,
                    device=None, seed: int = 0):
    """A content function over ContentVec at ``config`` (default: the
    full width, ``configs.CONTENTVEC_CONFIG``) on ``device`` (CUDA unless
    named), with weights from ``ckpt``: a ``.pt`` Hugging Face
    ``HubertModel`` state dict (path or dict), a flax tree of the JAX
    encoder, or None for seeded weights (``seed``; the JAX function
    returns None there, having no weights to draw).

    ``content_fn(audio16k)`` -> ``(frames, dim)`` numpy; its ``batch``
    (16 kHz waveforms) and ``batch24`` (24 kHz, resampled on the device)
    return tensors on the device, row slices of one batched forward per
    group of waveforms in one 2 s bucket, the group padded to a power of
    two by repeating its last waveform, as the JAX function groups them.
    """
    device = resolve_device(device)
    model = ContentVecEncoder(**dict(config or CONTENTVEC_CONFIG))
    model = load_contentvec_params(model, ckpt, seed).to(device).eval()

    def infer(wav: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(wav)

    def _bucket(audio16k):
        n = len(audio16k)
        padded = -(-n // BUCKET_16K) * BUCKET_16K
        wav = np.pad(np.asarray(audio16k, np.float32), (0, padded - n))
        return wav, _frames(n)

    def content_fn(audio16k):
        wav, n_frames = _bucket(audio16k)
        out = infer(upload(wav[None], device))
        return out[0, :n_frames].cpu().numpy()

    def _run_grouped(prepped, run_infer):
        """One forward per bucket and per chunk of ``batch_size``, the
        chunk padded to a power of two; each row sliced to its frames."""
        groups = {}
        for i, rec in enumerate(prepped):
            groups.setdefault(rec[0].shape[0], []).append(i)
        results = [None] * len(prepped)
        for idxs in groups.values():
            for lo in range(0, len(idxs), batch_size):
                chunk = idxs[lo:lo + batch_size]
                run = chunk + [chunk[-1]] * (next_pow2(len(chunk))
                                             - len(chunk))
                out = run_infer(run)
                for j, i in enumerate(chunk):
                    results[i] = out[j, :prepped[i][1]]
        return results

    def batch(audios16k):
        """Tensors on the device, one a waveform (the conversion pack
        takes them there: the 768-d features never come to the host)."""
        prepped = [_bucket(a) for a in audios16k]
        return _run_grouped(prepped, lambda run: infer(upload(
            np.stack([prepped[i][0] for i in run]), device)))

    def _bucket24(audio24k, wire_dtype):
        n = len(audio24k)
        padded = -(-n // BUCKET_24K) * BUCKET_24K
        wav = np.pad(np.asarray(audio24k, np.float32), (0, padded - n))
        if wire_dtype == "int16":
            wav = np.clip(np.round(wav * 32768.0),
                          -32768, 32767).astype(np.int16)
        n16 = (n * 2 + 2) // 3   # len(resample_poly(x, 2, 3))
        return wav, _frames(n16), n16

    def _infer24(w24: torch.Tensor, n16: torch.Tensor) -> torch.Tensor:
        # zero past each row's 16 kHz length: host resampling pads with
        # exact zeros, where resampling the padded signal leaves the
        # filter's ring-out, and the transformer attends to the tail
        y16 = resample_device(w24, 2, 3)
        keep = torch.arange(y16.shape[-1], device=y16.device) < n16[:, None]
        return infer(torch.where(keep, y16, 0.0))

    def batch24(audios24k, wire_dtype: str = "float32"):
        """``batch`` from 24 kHz waveforms: one upload (int16 on the
        ``"int16"`` wire, dequantized on the device), the 2/3 resample on
        the device, then ContentVec."""
        prepped = [_bucket24(a, wire_dtype) for a in audios24k]
        return _run_grouped(prepped, lambda run: _infer24(
            upload(np.stack([prepped[i][0] for i in run]), device),
            upload(np.asarray([prepped[i][2] for i in run], np.int64),
                   device)))

    content_fn.batch = batch
    content_fn.batch24 = batch24
    return content_fn


# -- the CLI ----------------------------------------------------------------

# the JAX CLI's backends; its "jax" is the port's plain "yin"
F0_BACKENDS = ("viterbi", "harvest", "jax", "native", "harvest_native")


def build_argparser():
    p = argparse.ArgumentParser(description="extract SSC features (PyTorch)")
    p.add_argument("--wav-scp", "--scp", required=True)
    p.add_argument("--segments", default=None)
    p.add_argument("--dumpdir", required=True)
    p.add_argument("--midi-path", default=None,
                   help="file mapping utt_id -> wav path whose .json holds "
                        "the GT score (GTSinger layout)")
    p.add_argument("--f0-path", default=None, help="per-voice f0 range yaml")
    p.add_argument("--skip-gtmidi", type=str2bool, default=False)
    p.add_argument("--config", required=True)
    p.add_argument("--contentvec-ckpt", default=None,
                   help=".pt Hugging Face HubertModel state dict "
                        "(ContentVec)")
    p.add_argument("--midi-model-ckpt", default=None,
                   help="phoneme-MIDI transcriber checkpoint (upstream "
                        "midi_model.pt; optional)")
    p.add_argument("--allow-missing-hubert", type=str2bool, default=False)
    p.add_argument("--f0-backend", choices=F0_BACKENDS,
                   default="viterbi",
                   help="F0 estimator: YIN + Viterbi (default), plain "
                        "YIN ('jax') or Harvest on the device, or YIN "
                        "('native') or Harvest ('harvest_native') on the "
                        "host")
    p.add_argument("--batch-size", type=int, default=8,
                   help="utterances of one length bucket and F0 range "
                        "extracted together")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--verbose", type=int, default=1)
    return p


def setup_logging(verbose: int):
    level = (logging.DEBUG if verbose > 1
             else logging.INFO if verbose > 0 else logging.WARN)
    logging.basicConfig(
        level=level, format="%(asctime)s (%(module)s:%(lineno)d) "
                            "%(levelname)s: %(message)s")


def load_gt_note_map(midi_path):
    """``utt_id /path/to/x.wav`` lines -> {utt_id: "/path/to/x.json"}, the
    note sequence beside each wav (empty when ``midi_path`` is None or
    missing)."""
    mapping = {}
    if midi_path is None:
        return mapping
    if not os.path.exists(midi_path):
        logging.warning("midi map %s not found; GT score disabled", midi_path)
        return mapping
    with open(midi_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(" /", 1)
            if len(parts) != 2:
                continue
            mapping[parts[0]] = "/" + parts[1].replace(".wav", ".json")
    return mapping


def run(args, with_f0_fluc: bool):
    """Dump every utterance of ``args.wav_scp`` (``f0_fluc`` too with
    ``with_f0_fluc``)."""
    from serenade_tpu_torch import resolve_device
    from serenade_tpu_torch.config import _yaml, load_config
    from serenade_tpu_torch.datasets.audio_dataset import AudioSCPDataset
    from serenade_tpu_torch.features import (
        FeatureConfig, check_f0_backend, extract_features_batch,
    )
    from serenade_tpu_torch.utils.h5 import write_hdf5

    setup_logging(args.verbose)
    backend = "yin" if args.f0_backend == "jax" else args.f0_backend
    check_f0_backend(backend)
    if args.contentvec_ckpt is None and not args.allow_missing_hubert:
        raise SystemExit("no --contentvec-ckpt given; pass "
                         "--allow-missing-hubert true to dump without "
                         "content features")
    dev = resolve_device(args.device)
    fc = FeatureConfig.from_dict(load_config(args.config))
    dataset = AudioSCPDataset(args.wav_scp, segments=args.segments)
    os.makedirs(args.dumpdir, exist_ok=True)
    f0_table = None
    if args.f0_path:
        with open(args.f0_path) as f:
            f0_table = _yaml().safe_load(f)
    gt_map = load_gt_note_map(args.midi_path)
    content_fn = (make_content_fn(args.contentvec_ckpt, device=dev)
                  if args.contentvec_ckpt else None)
    midi_fn = None
    if args.midi_model_ckpt:
        from serenade_tpu_torch.modules.phoneme_midi import load_transcriber

        midi_fn = load_transcriber(args.midi_model_ckpt, device=dev)
    batch_size = max(int(args.batch_size or 1), 1)
    n_done = 0

    def flush(pending):
        nonlocal n_done
        if not pending:
            return
        results = extract_features_batch(
            pending, fc, f0_table=f0_table, content_fn=content_fn,
            midi_transcribe_fn=midi_fn, with_f0_fluc=with_f0_fluc,
            f0_backend=backend,
            max_group=batch_size, device=dev)
        for utt_id, _, _, _ in pending:
            feats = results.get(utt_id)
            if feats is None:
                continue
            out = os.path.join(args.dumpdir, f"{utt_id}.h5")
            for key, value in feats.items():
                if torch.is_tensor(value):      # content features
                    value = value.cpu().numpy()
                write_hdf5(out, key, value)
            n_done += 1
            logging.info("dumped %s (%d frames)", utt_id,
                         feats["logmel"].shape[0])

    # a window of utterances, so same-bucket, same-singer groups share
    # one extraction pass
    window = batch_size * 8
    pending = []
    for utt_id, (audio, fs) in dataset:
        gt_note_seq = None
        if not args.skip_gtmidi and utt_id in gt_map:
            path = gt_map[utt_id]
            if not os.path.exists(path):
                logging.info("WARNING: %s has missing midi information",
                             utt_id)
                continue
            with open(path) as f:
                gt_note_seq = json.load(f)
        elif not args.skip_gtmidi and gt_map:
            logging.info("WARNING: %s not in midi map", utt_id)
            continue
        pending.append((utt_id, audio, fs, gt_note_seq))
        if len(pending) >= window:
            flush(pending)
            pending = []
    flush(pending)
    logging.info("preprocessing done: %d utterances", n_done)


def main(argv=None):
    run(build_argparser().parse_args(argv), with_f0_fluc=False)


if __name__ == "__main__":
    main()
