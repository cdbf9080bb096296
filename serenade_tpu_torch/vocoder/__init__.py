from serenade_tpu_torch.vocoder.hifigan import HiFiGANGenerator  # noqa: F401
from serenade_tpu_torch.vocoder.vocoder import (  # noqa: F401
    Vocoder,
    load_vocoder,
)
