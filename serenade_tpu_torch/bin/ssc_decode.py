"""The decode CLI (counterpart of serenade_tpu/bin/ssc_decode.py)::

    python -m serenade_tpu_torch.bin.ssc_decode --dumpdir dump/test \\
        --stats dump/train/stats.joblib --outdir exp/decoded \\
        --checkpoint exp/checkpoint-200000steps.pkl \\
        --ref-dict styles.json --batch-size 4

For every source utterance of the dump and every reference style it
converts the features, vocodes the mel and writes ``{utt}_{style}.wav``
and ``{utt}_{style}.h5`` (the source F0 shifted toward the reference's
register by ``linear_midi_shift``, as ``lf0``; the mel too when no vocoder
is configured), plus ``{utt}_gt.wav`` and ``00_{style}_reference.wav``.
``--checkpoint`` is a checkpoint directory of the port
(``checkpoint-<N>steps``; ``--average-n`` averages the last N of its
directory) or the upstream reference's torch ``.pkl``.  The experiment's
``config.yml`` sits beside the checkpoint unless ``--config`` names it.
A checkpoint of the F0-fluctuation variant (its config's model type)
decodes with its dumps' and references' ``f0_fluc`` too;
``bin/ssc_decode_new.py`` is the same CLI under the variant's name.
``--data-axis N`` converts each chunk on N replicas of the converter
(``cuda:0`` .. ``cuda:N-1``, or N CPU replicas with ``--device cpu``),
each its own rows, as the JAX decode shards a chunk over its data mesh.

Two parts: :func:`decode_core` converts feature dicts held in memory
(torch and numpy only), and :func:`main` reads the dump, the statistics,
the config and the vocoder's files (``h5py``, ``joblib``, ``pyyaml``) and
writes the outputs.  Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import time
from collections import defaultdict

import numpy as np

from serenade_tpu_torch.collaters.ssc import bucket_length
from serenade_tpu_torch.ops.f0_stats import linear_midi_shift

STYLES = ("Breathy", "Falsetto", "Pharyngeal", "Mixed_Voice")


def build_argparser():
    p = argparse.ArgumentParser(
        description="decode with a trained SSC model (PyTorch)")
    p.add_argument("--config", default=None)
    p.add_argument("--feats-scp", "--scp", default=None,
                   help="refused: the decode reads --dumpdir")
    p.add_argument("--dumpdir", default=None)
    p.add_argument("--stats", required=True,
                   help="stats.joblib of fitted scalers, or an .npz of "
                        "<feature>_<stat> arrays")
    p.add_argument("--ref-dict", default=None,
                   help="json mapping style name -> reference dump h5")
    p.add_argument("--outdir", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint-<N>steps directory, or a reference "
                        "torch .pkl")
    p.add_argument("--average-n", type=int, default=1,
                   help="average the last N checkpoints of the "
                        "checkpoint's directory, ending at its step")
    p.add_argument("--batch-size", type=int, default=1,
                   help="conversions of one (source, reference) bucket "
                        "pair batched together")
    p.add_argument("--n-timesteps", type=int, default=None,
                   help="CFM ODE steps (default: the config's "
                        "inference_n_timesteps, else 10)")
    p.add_argument("--temperature", type=float, default=0.667)
    p.add_argument("--solver", default=None,
                   choices=("euler", "midpoint", "ab2"),
                   help="CFM ODE solver (default: the config's "
                        "inference_solver, else euler)")
    p.add_argument("--data-axis", type=int, default=1,
                   help="convert each chunk data-parallel over N replicas "
                        "(cuda:0 .. cuda:N-1; N replicas of the CPU with "
                        "--device cpu), chunks padded to a multiple of N")
    p.add_argument("--num-shards", type=int, default=1,
                   help="partition the utterance list for array-job decode")
    p.add_argument("--shard", type=int, default=1,
                   help="1-based shard index")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--verbose", type=int, default=1)
    return p


# -- the decode core: feature dicts in memory -------------------------------


def plan_chunks(sources, styles, references, batch_size: int):
    """The work of a decode in the order it runs: ``[((ts, tr), [(utt_id,
    style, ref_key), ...]), ...]``, grouped by the pair of bucketed lengths
    (``collaters.ssc.bucket_length`` of the source's and the reference's
    frames) in the order the groups first appear, each group cut into
    chunks of at most ``batch_size``.  A style already named in an
    utterance's id is skipped (no reconstruction)."""
    groups = defaultdict(list)
    for utt_id, src in sources.items():
        for style, ref_key in styles[utt_id].items():
            if style in utt_id:
                continue
            key = (bucket_length(src["hubert"].shape[0]),
                   bucket_length(references[ref_key]["hubert"].shape[0]))
            groups[key].append((utt_id, style, ref_key))
    bs = max(1, batch_size)
    return [(key, work[i:i + bs]) for key, work in groups.items()
            for i in range(0, len(work), bs)]


def decode_core(conv, sources, styles, references, batch_size: int = 1,
                noise=None):
    """Convert every (source, style) pair, a chunk at a time.

    ``sources``: utterance id -> features (``hubert``, ``score``,
    ``loud``, ``lf0``, un-normalized: ``conv`` normalizes them with its
    statistics); ``styles``: utterance id -> {style: reference key};
    ``references``: reference key -> features (``hubert``, ``score``,
    ``loud``, ``logmel``, ``f0``).  Each chunk of :func:`plan_chunks`
    runs as one batched ``conv.convert_features_batch`` at its group's
    buckets, from noise drawn by ``conv.draw_noise`` (or by ``noise(b,
    t)`` where given) and, for the F0-fluctuation variant (whose features
    carry ``f0_fluc``), the shifts drawn next by ``conv.draw_shifts``;
    each mel is then vocoded alone at its length.

    Yields ``((ts, tr), results)`` per chunk, each result a dict with
    ``utt_id``, ``style``, ``ref_key``, ``mel`` ``(t_src, mels)``, ``wav``
    (None without a vocoder), ``lf0`` (the source F0 shifted by
    ``linear_midi_shift`` toward the reference's), ``x0``, the chunk's
    noise row it started from, and ``shifts``, the chunk's (None but for
    the variant)."""
    draw = noise or conv.draw_noise
    n_dev = conv.mesh.size if getattr(conv, "mesh", None) is not None else 1
    for (ts, tr), chunk in plan_chunks(sources, styles, references,
                                       batch_size):
        # a data mesh needs rows on every replica: the chunk's last pair
        # repeats, as in the JAX decode
        padded = chunk + [chunk[-1]] * ((-len(chunk)) % n_dev)
        x0 = draw(len(padded), tr + ts)
        sh = conv.draw_shifts(ts) if conv.variant_new else None
        mels, lens = conv.convert_features_batch(
            [sources[u] for u, _, _ in padded],
            [references[r] for _, _, r in padded], ts=ts, tr=tr,
            return_device=True, x0=x0, shifts=sh)
        results = []
        for i, (utt_id, style, ref_key) in enumerate(chunk):
            mel = mels[i:i + 1, :lens[i]]
            wav = (conv.vocoder.synthesize(mel)[0].cpu().numpy()
                   if conv.vocoder is not None else None)
            lf0 = linear_midi_shift(
                np.asarray(sources[utt_id]["lf0"]).reshape(-1),
                np.asarray(references[ref_key]["f0"]).reshape(-1))
            results.append({"utt_id": utt_id, "style": style,
                            "ref_key": ref_key, "mel": mel[0].cpu().numpy(),
                            "wav": wav, "lf0": lf0.astype(np.float32),
                            "x0": x0[i:i + 1], "shifts": sh})
        yield (ts, tr), results


# -- the file shell ---------------------------------------------------------


def get_random_ref_style(dumpdir: str, utt_id: str):
    """One reference dump per style for this singer, searching every
    sibling ``dump.*`` shard, picked by ``np.random.choice`` as the JAX
    package picks it (a seeded ``np.random`` gives the same picks)."""
    dirname = os.path.dirname(os.path.join(dumpdir, f"{utt_id}.h5"))
    ln, spk = utt_id.split("_")[:2]
    search_dirs = [dirname]
    parent = os.path.dirname(dirname.rstrip("/"))
    base = os.path.basename(dirname.rstrip("/"))
    if "." in base:
        stem = base.split(".")[0]
        search_dirs = sorted(glob.glob(os.path.join(parent, f"{stem}.*")))
    ref_dict = {}
    for style in STYLES:
        for d in search_dirs:
            files = glob.glob(os.path.join(
                d, f"{ln}_{spk}_*_{style}_Group_*.h5"))
            if files:
                ref_dict[style] = np.random.choice(files)
                break
    logging.info("using reference styles: %s", ref_dict)
    return ref_dict


def read_reference(h5path: str, with_fluc: bool = False) -> dict:
    """A reference dump's features, un-normalized (the Converter applies
    the statistics as the JAX decode's ``_norm_ref`` does), with its F0
    and waveform, and its ``f0_fluc`` for the variant (``with_fluc``)."""
    from serenade_tpu_torch.utils.h5 import read_hdf5_many

    raw = read_hdf5_many(h5path, ("hubert", "logmel", "loud",
                                  "est_lf0_score", "f0", "wave")
                         + (("f0_fluc",) if with_fluc else ()))
    raw["score"] = raw.pop("est_lf0_score")
    missing = [k for k, v in raw.items() if v is None]
    if missing:
        raise KeyError(f"{h5path} lacks {missing}")
    return raw


def _average_params(args):
    """The f32 mean of the last ``--average-n`` checkpoints ending at
    ``--checkpoint``'s step, or None to load ``--checkpoint`` alone."""
    from serenade_tpu_torch.checkpoint import (
        average_checkpoints, checkpoint_step, find_last_checkpoints,
    )

    if args.average_n <= 1:
        return None
    if args.checkpoint.endswith(".pkl"):
        raise SystemExit("--average-n needs checkpoint directories; a "
                         "converted torch .pkl is a single snapshot")
    # the window ends at the given checkpoint's step, so pointing at an
    # older snapshot does not average the newest N instead
    anchor = checkpoint_step(args.checkpoint)
    if anchor is None:
        logging.warning("--average-n: %s is not a step-named checkpoint; "
                        "averaging the newest %d in its directory",
                        args.checkpoint, args.average_n)
    paths = find_last_checkpoints(os.path.dirname(args.checkpoint),
                                  args.average_n, max_step=anchor)
    logging.info("averaging %d checkpoints: %s", len(paths),
                 [os.path.basename(p) for p in paths])
    return average_checkpoints(paths)


def main(argv=None):
    """The decode; a checkpoint of the F0-fluctuation variant reads
    ``FeatsDatasetNew`` sources and references with ``f0_fluc``."""
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: "
               "%(message)s")
    if args.feats_scp is not None:
        raise SystemExit("--feats-scp: the decode reads the dump "
                         "directory; pass --dumpdir")
    if args.dumpdir is None:
        raise SystemExit("--dumpdir is required")

    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.datasets.feats_dataset import (
        FeatsDataset, FeatsDatasetNew,
    )
    from serenade_tpu_torch.utils.audio import write_wav
    from serenade_tpu_torch.utils.h5 import write_hdf5

    os.makedirs(args.outdir, exist_ok=True)
    # the config's sampler (a distilled checkpoint recommends its own)
    # unless the flags name one
    conv = Converter.from_expdir(
        os.path.dirname(args.checkpoint), args.stats,
        checkpoint=args.checkpoint, n_timesteps=args.n_timesteps,
        solver=args.solver, temperature=args.temperature, seed=args.seed,
        device=args.device, config=args.config,
        params=_average_params(args), data_mesh=args.data_axis)
    logging.info("loaded %s", args.checkpoint)
    if conv.vocoder is None:
        logging.warning("no vocoder available; writing mel h5 instead of "
                        "wavs")

    dataset_cls = FeatsDatasetNew if conv.variant_new else FeatsDataset
    dataset = dataset_cls(root_dir=args.dumpdir,
                          score_type="est_lf0_score", return_utt_id=True)
    utt_indices = list(range(len(dataset)))
    if args.num_shards > 1:
        utt_indices = utt_indices[args.shard - 1::args.num_shards]
        logging.info("shard %d/%d: %d of %d utterances", args.shard,
                     args.num_shards, len(utt_indices), len(dataset))
    logging.info("decoding %d utterances", len(utt_indices))
    ref_dict = None
    if args.ref_dict:
        with open(args.ref_dict) as f:
            ref_dict = json.load(f)

    sr_out = int(conv.config["sampling_rate"])
    sources, styles, references = {}, {}, {}
    for idx in utt_indices:
        utt_id, item = dataset[idx]
        write_wav(os.path.join(args.outdir, f"{utt_id}_gt.wav"),
                  item["wave"], sr_out)
        utt_refs = ref_dict or get_random_ref_style(args.dumpdir, utt_id)
        for style, ref_h5 in utt_refs.items():
            if style in utt_id or ref_h5 in references:
                continue
            references[ref_h5] = read_reference(ref_h5,
                                                with_fluc=conv.variant_new)
            # only shard 1 writes the shared reference wavs: concurrent
            # shards would race on the same path
            if args.shard == 1:
                write_wav(os.path.join(args.outdir,
                                       f"00_{style}_reference.wav"),
                          references[ref_h5]["wave"], sr_out)
        sources[utt_id], styles[utt_id] = item, utt_refs

    shift_s = float(conv.config.get("shiftms", 10)) / 1000.0
    start = time.time()
    for _, results in decode_core(conv, sources, styles, references,
                                  args.batch_size):
        for r in results:
            out = os.path.join(args.outdir, f"{r['utt_id']}_{r['style']}")
            write_hdf5(f"{out}.h5", "lf0", r["lf0"])
            if r["wav"] is not None:
                write_wav(f"{out}.wav", r["wav"], conv.vocoder.sampling_rate)
            else:
                write_hdf5(f"{out}.h5", "mel", r["mel"].astype(np.float32))
        audio_s = sum(r["mel"].shape[0] for r in results) * shift_s
        logging.info("batch of %d decoded (RTF %.4f)", len(results),
                     (time.time() - start) / max(audio_s, 1e-6))
        start = time.time()


if __name__ == "__main__":
    main()
