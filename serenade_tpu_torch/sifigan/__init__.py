"""SiFiGAN source-filter vocoder (counterpart of serenade_tpu/sifigan/):
the generator, its input features and the released-checkpoint
converter.  The JAX package's ``torch_twin.py`` is already PyTorch, the
upstream layout the tests write released checkpoints from; the port
needs no copy of it."""

from serenade_tpu_torch.sifigan.features import (  # noqa: F401
    SignalGenerator, dense_factors_per_level, dilated_factor, world_mcep_bap,
)
from serenade_tpu_torch.sifigan.generator import (  # noqa: F401
    QPResidualBlock, SiFiGANDirectGenerator, SiFiGANGenerator, pd_gather,
    pitch_dependent_conv,
)
