"""The F0-fluctuation variant's decode CLI (counterpart of
serenade_tpu/bin/ssc_decode_new.py): ``bin/ssc_decode.py`` under the
variant's name; a SerenadeNew checkpoint's config makes it feed the
sources' and references' ``f0_fluc``::

    python -m serenade_tpu_torch.bin.ssc_decode_new --dumpdir dump/test \\
        --stats dump/train/stats.joblib --outdir exp/decoded \\
        --checkpoint exp/serenade_new/checkpoint-200000steps.pkl

``--checkpoint`` is a port checkpoint directory or the upstream
reference's torch ``.pkl`` of its SerenadeNew (converted; its first UNet
convolution takes the two F0-fluctuation channels).
"""

from __future__ import annotations

from serenade_tpu_torch.bin.ssc_decode import main


if __name__ == "__main__":
    main()
