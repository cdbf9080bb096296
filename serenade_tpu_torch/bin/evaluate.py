"""The evaluation CLI (counterpart of serenade_tpu/bin/evaluate.py)::

    python -m serenade_tpu_torch.bin.evaluate \\
        --converted-dir exp/decoded --target-dir data/gt_wav \\
        --out results.json [--device cpu]

Pairs each converted wav with its target (ground truth, the source, or a
parallel rendition), runs the analysis chain of ``metrics.py`` (F0,
CheapTrick, mel-cepstrum) and reports MCD, log-F0 RMSE and V/UV error per
utterance and averaged; it prints the summary as one JSON line.

Pairing: for each wav under ``--converted-dir`` the target is the same
stem in ``--target-dir`` (or the utterance id of ``--target-scp``) after
stripping ``--strip-suffixes`` from the converted stem (the decode writes
``<utt>_<style>.wav``).  With ``--expdir``, ``--stats`` and
``--ref-dict`` it adds ``style_cos``, the cosine of the GST embeddings of
each converted wav and of its style's reference (``Converter.
from_expdir``; needs pyyaml, h5py and joblib).  Without ``--expdir`` it
needs scipy only to read the wavs.  Runs on CUDA unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import logging
import os


def _stem_key(name: str, strip_suffixes) -> str:
    stem = os.path.splitext(os.path.basename(name))[0]
    for suf in strip_suffixes:
        if suf and stem.endswith(suf):
            stem = stem[: -len(suf)]
    return stem


def _index_wavs(root: str):
    out = {}
    for dirpath, _dirnames, filenames in os.walk(root):
        for f in filenames:
            if fnmatch.fnmatch(f, "*.wav"):
                stem = os.path.splitext(f)[0]
                if stem in out:
                    logging.warning(
                        "duplicate target stem %r: %s shadows %s "
                        "(targets index by bare filename stem)",
                        stem, os.path.join(dirpath, f), out[stem])
                out[stem] = os.path.join(dirpath, f)
    return out


def build_argparser():
    p = argparse.ArgumentParser(
        description="objective evaluation of converted wavs (PyTorch)")
    p.add_argument("--converted-dir", required=True)
    p.add_argument("--target-dir", default=None,
                   help="directory of target wavs, indexed by filename stem")
    p.add_argument("--target-scp", default=None,
                   help="kaldi wav.scp indexing targets by utterance id")
    p.add_argument("--strip-suffixes", nargs="*",
                   default=["_sifigan", "_Breathy", "_Falsetto",
                            "_Pharyngeal", "_Mixed_Voice"],
                   help="suffixes stripped from converted stems before "
                        "pairing (decode style tags, stage-9 _sifigan)")
    p.add_argument("--exclude", nargs="*",
                   default=["*_gt", "*_reference"],
                   help="converted stems to skip (glob, like stage 9)")
    p.add_argument("--f0-backend", default="viterbi",
                   choices=("viterbi", "yin", "harvest"),
                   help="preprocessing's names: viterbi (YIN+Viterbi, "
                        "default), yin (plain), harvest")
    p.add_argument("--frame-period-ms", type=float, default=5.0)
    p.add_argument("--mcep-order", type=int, default=34)
    p.add_argument("--no-dtw", action="store_true",
                   help="pair frames by index instead of DTW alignment")
    p.add_argument("--expdir", default=None,
                   help="experiment dir (with --stats and --ref-dict: "
                        "adds style_cos, the GST-embedding cosine of each "
                        "converted wav and its style reference)")
    p.add_argument("--stats", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--ref-dict", default=None,
                   help="style -> reference h5 map (decode's "
                        "refstyles.json)")
    p.add_argument("--out", default=None, help="write JSON here as well")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--verbose", type=int, default=1)
    return p


def _style_scorer(args):
    """``(stem, wav, sr) -> style_cos or None`` from the experiment's
    GST, or None without ``--expdir``, ``--stats`` and ``--ref-dict``."""
    if not (args.expdir and args.stats and args.ref_dict):
        return None
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.metrics import cosine_similarity
    from serenade_tpu_torch.utils.h5 import read_hdf5

    conv = Converter.from_expdir(args.expdir, args.stats,
                                 checkpoint=args.checkpoint,
                                 device=args.device)
    with open(args.ref_dict) as f:
        ref_map = json.load(f)
    ref_embs = {style: conv.style_embedding(logmel=read_hdf5(path, "logmel"))
                for style, path in ref_map.items()}

    def score(stem, wav, sr):
        # peel the suffixes one at a time, looking for a style tag before
        # each strip (the strip list usually holds the style tags)
        s = stem
        while True:
            for style, emb in ref_embs.items():
                if s.endswith(f"_{style}"):
                    return cosine_similarity(conv.style_embedding(wav, sr),
                                             emb)
            for suf in args.strip_suffixes:
                if suf and s.endswith(suf):
                    s = s[: -len(suf)]
                    break
            else:
                return None

    return score


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: "
               "%(message)s")

    from serenade_tpu_torch import resolve_device
    from serenade_tpu_torch.features import check_f0_backend
    from serenade_tpu_torch.metrics import (
        extract_eval_feats_batch, pair_metrics, summarize,
    )
    from serenade_tpu_torch.utils.audio import read_wav, resample

    check_f0_backend(args.f0_backend, host=False)
    dev = resolve_device(args.device)
    if not args.target_dir and not args.target_scp:
        raise SystemExit("need --target-dir or --target-scp")
    targets = {}
    if args.target_dir:
        targets.update(_index_wavs(args.target_dir))
    if args.target_scp:
        with open(args.target_scp) as f:
            for line in f:
                parts = line.strip().split(maxsplit=1)
                if len(parts) == 2:
                    targets[parts[0]] = parts[1]
    if not targets:
        raise SystemExit(
            f"no target wavs under {args.target_dir or args.target_scp}")
    style_scorer = _style_scorer(args)

    # every pair first, then batched analysis: same-bucket clips share one
    # pass on the device
    pairs = []  # (stem, wav_c, wav_t, sr)
    n_skipped = 0
    for dirpath, _dirnames, filenames in os.walk(args.converted_dir):
        for f in sorted(filenames):
            if not fnmatch.fnmatch(f, "*.wav"):
                continue
            stem = os.path.splitext(f)[0]
            if any(fnmatch.fnmatch(stem, pat) for pat in args.exclude):
                continue
            key = _stem_key(f, args.strip_suffixes)
            tgt = targets.get(key) or targets.get(stem)
            if tgt is None:
                logging.info("no target for %s (key %s); skipped", f, key)
                n_skipped += 1
                continue
            wav_c, sr_c = read_wav(os.path.join(dirpath, f))
            wav_t, sr_t = read_wav(tgt)
            if sr_c != sr_t:
                wav_t = resample(wav_t, sr_t, sr_c)
            if any(s == stem for s, *_ in pairs):
                # per-style subdirs can repeat a filename
                rel = os.path.relpath(os.path.join(dirpath, f),
                                      args.converted_dir)
                logging.warning("duplicate converted stem %r; reporting "
                                "it as %r", stem, rel)
                stem = os.path.splitext(rel)[0]
            pairs.append((stem, wav_c, wav_t, sr_c))

    feats_c = [None] * len(pairs)
    feats_t = [None] * len(pairs)
    by_sr = {}
    for i, (_stem, _wc, _wt, sr) in enumerate(pairs):
        by_sr.setdefault(sr, []).append(i)
    kw = dict(f0_backend=args.f0_backend,
              frame_period_ms=args.frame_period_ms,
              mcep_order=args.mcep_order, device=dev)
    for sr, idxs in by_sr.items():
        fc = extract_eval_feats_batch([pairs[i][1] for i in idxs], sr, **kw)
        ft = extract_eval_feats_batch([pairs[i][2] for i in idxs], sr, **kw)
        for j, i in enumerate(idxs):
            feats_c[i], feats_t[i] = fc[j], ft[j]

    per_utt = {}
    for i, (stem, wav_c, _wav_t, sr_c) in enumerate(pairs):
        if feats_c[i] is None or feats_t[i] is None:
            logging.warning("skipping %s: corrupt waveform "
                            "(non-finite/empty)", stem)
            n_skipped += 1
            continue
        m = pair_metrics(feats_c[i], feats_t[i], use_dtw=not args.no_dtw)
        if style_scorer is not None:
            m["style_cos"] = style_scorer(stem, wav_c, sr_c)
        per_utt[stem] = m
        logging.info(
            "%s: MCD %.3f dB, F0 RMSE %s cents, VUV err %.3f",
            stem, m["mcd_db"],
            "n/a" if m["f0_rmse_cents"] is None
            else f"{m['f0_rmse_cents']:.1f}",
            m["vuv_error"])

    if not per_utt:
        raise SystemExit("no (converted, target) pairs found")
    result = {"summary": summarize(per_utt), "skipped": n_skipped,
              "per_utterance": per_utt}
    print(json.dumps(result["summary"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
        logging.info("wrote %s", args.out)
    return result


if __name__ == "__main__":
    main()
