"""Export a trained experiment as a deployment artifact (counterpart of
serenade_tpu/bin/export.py).

Writes the conversion's hot path (normalization, CFM inference and, with
the config's vocoder, HiFiGAN) as one ``torch.export`` program a bucket and
platform, weights baked in, with a manifest: see
``serenade_tpu_torch/deploy.py``.  ``deploy.load`` and ``bin/serve.py
--artifact`` run the directory with no model code, config registry or
checkpoint machinery::

    python -m serenade_tpu_torch.bin.export --expdir exp/train_serenade \\
        --stats dump/stats.joblib --out-dir exp/train_serenade/export \\
        --buckets 512x512,1024x512,2048x1024 --platforms cuda,cpu

Reading the experiment needs ``pyyaml``, ``h5py`` (the vocoder's
statistics) and ``joblib`` (a ``stats.joblib``), as
``Converter.from_expdir`` does.  Exports on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging


def _parse_buckets(spec: str):
    out = []
    for part in spec.split(","):
        ts, tr = part.lower().split("x")
        out.append((int(ts), int(tr)))
    return out


def build_argparser():
    p = argparse.ArgumentParser(
        description="export a trained SSC experiment to a deployment "
                    "artifact (PyTorch)")
    p.add_argument("--expdir", required=True,
                   help="experiment dir (config.yml and checkpoints)")
    p.add_argument("--stats", required=True,
                   help="stats.joblib of fitted scalers, or an .npz of the "
                        "scaler arrays")
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint directory or a reference torch .pkl "
                        "(default: the latest under --expdir)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--buckets", default="1024x512",
                   help="comma list of SRCxREF frame buckets, e.g. "
                        "'512x512,1024x512,2048x1024'; a request takes the "
                        "fitting bucket of least padded work")
    p.add_argument("--n-timesteps", type=int, default=None,
                   help="ODE steps baked into the programs (default: the "
                        "config's inference_n_timesteps, else 10)")
    p.add_argument("--solver", default=None,
                   choices=("euler", "midpoint", "ab2"),
                   help="CFM solver (default: the config's "
                        "inference_solver, else euler)")
    p.add_argument("--temperature", type=float, default=0.667)
    p.add_argument("--quantize", default=None, choices=("int8",),
                   help="int8 weights as the programs' constants, "
                        "dequantized per channel inside each program")
    p.add_argument("--platforms", default=None,
                   help="comma list of cuda, cpu (default: --device and "
                        "cpu)")
    p.add_argument("--device", default=None,
                   help="torch device the Converter is built on (default: "
                        "cuda)")
    p.add_argument("--verbose", type=int, default=1)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: "
               "%(message)s")

    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.deploy import export_converter

    conv = Converter.from_expdir(
        args.expdir, args.stats, checkpoint=args.checkpoint,
        n_timesteps=args.n_timesteps, solver=args.solver,
        temperature=args.temperature, quantize=args.quantize,
        device=args.device)
    platforms = (tuple(s.strip() for s in args.platforms.split(","))
                 if args.platforms else None)
    # conv.solver is the resolved choice: the flag, else the config's
    # inference_solver, else euler
    manifest = export_converter(
        conv, args.out_dir, buckets=_parse_buckets(args.buckets),
        platforms=platforms, solver=conv.solver)
    logging.info("exported %d bucket program(s) to %s (platforms: %s)",
                 len(manifest["files"]), args.out_dir,
                 ",".join(manifest["platforms"]))


if __name__ == "__main__":
    main()
