"""The F0-fluctuation variant's preprocessing CLI (counterpart of
serenade_tpu/bin/preprocess_new.py): ``bin/preprocess.py`` with the
``f0_fluc`` stream in every dump::

    python -m serenade_tpu_torch.bin.preprocess_new \\
        --wav-scp data/train/wav.scp --dumpdir dump/train \\
        --config conf/serenade_new.yaml --contentvec-ckpt content-vec.pt
"""

from __future__ import annotations

from serenade_tpu_torch.bin.preprocess import build_argparser, run


def main(argv=None):
    run(build_argparser().parse_args(argv), with_f0_fluc=True)


if __name__ == "__main__":
    main()
