"""Fit the feature scalers over a train dump (counterpart of
serenade_tpu/bin/compute_statistics.py)::

    python -m serenade_tpu_torch.bin.compute_statistics \\
        --rootdir dump/train --dumpdir dump/train --config conf/serenade.yaml

A StandardScaler for hubert and logmel and a MinMaxScaler for the score
(``score_type``) and loud, fitted utterance by utterance and written as
``stats.joblib`` with ``joblib.dump``.  The file loads through
``utils.scalers.load_scalers`` and through a plain ``joblib.load``, the
JAX package's reader.  Needs h5py, joblib and pyyaml.
"""

from __future__ import annotations

import argparse
import logging
import os

from serenade_tpu_torch.config import load_config
from serenade_tpu_torch.utils.scalers import MinMaxScaler, StandardScaler


def build_argparser():
    p = argparse.ArgumentParser(description="fit feature scalers")
    p.add_argument("--rootdir", required=True, help="train dump directory")
    p.add_argument("--dumpdir", required=True,
                   help="where to put stats.joblib")
    p.add_argument("--config", required=True)
    p.add_argument("--verbose", type=int, default=1)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: "
               "%(message)s")
    config = load_config(args.config)

    import h5py
    import joblib

    from serenade_tpu_torch.utils.h5 import find_files

    files = sorted(find_files(args.rootdir, "*.h5"))
    if not files:
        raise SystemExit(f"no h5 dumps under {args.rootdir}")
    scaler = {"hubert": StandardScaler(), "logmel": StandardScaler(),
              "score": MinMaxScaler(), "loud": MinMaxScaler()}
    key_map = {"hubert": "hubert", "logmel": "logmel",
               "score": config.get("score_type", "est_lf0_score"),
               "loud": "loud"}
    seen = {k: 0 for k in scaler}
    for path in files:
        with h5py.File(path, "r") as f:
            for name, h5key in key_map.items():
                if h5key not in f:
                    continue  # e.g. dumps without content features
                scaler[name].partial_fit(f[h5key][()])
                seen[name] += 1
    for name, count in seen.items():
        if count == 0:
            logging.warning("no %r found in any dump; scaler left unfitted",
                            name)
        else:
            logging.info("fitted %s over %d utterances", name, count)

    os.makedirs(args.dumpdir, exist_ok=True)
    out = os.path.join(args.dumpdir, "stats.joblib")
    joblib.dump(scaler, out)
    logging.info("saved scaler statistics to %s", out)


if __name__ == "__main__":
    main()
