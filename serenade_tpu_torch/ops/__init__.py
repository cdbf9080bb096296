from serenade_tpu_torch.ops.attention import (  # noqa: F401
    multi_head_attention,
)
