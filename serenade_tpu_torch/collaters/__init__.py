from serenade_tpu_torch.collaters.ssc import (  # noqa: F401
    SSCCollater,
    SSCCollaterNew,
)
