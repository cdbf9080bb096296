"""The F0-fluctuation variant's training CLI (counterpart of
serenade_tpu/bin/ssc_train_new.py): ``bin/ssc_train.py`` with
``FeatsDatasetNew`` as the default dataset::

    python -m serenade_tpu_torch.bin.ssc_train_new \\
        --train-dumpdir dump/train --dev-dumpdir dump/dev \\
        --stats dump/stats.joblib --outdir exp/serenade_new \\
        --config conf/serenade_new.yaml

The config names ``SerenadeNew``, ``SSCTrainerNew`` and
``SSCCollaterNew``; the dumps carry ``f0_fluc`` (``bin/preprocess_new``).
"""

from __future__ import annotations

from serenade_tpu_torch.bin.ssc_train import main as _main


def main(argv=None):
    _main(argv, dataset_name="FeatsDatasetNew")


if __name__ == "__main__":
    main()
