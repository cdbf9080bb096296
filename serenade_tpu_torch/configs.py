"""Full-width configurations, carried as dicts so the port reads no YAML.
``tests/test_torch_slice.py`` holds them equal to the recipe files they
cite."""

from __future__ import annotations

# egs/gtsinger/ssc1/conf/serenade.yaml ``model_params``, computed in bf16
# (the Serenade default dtype, serenade_tpu/models/serenade.py:59)
SERENADE_MODEL_PARAMS = {
    "input_dim": 768,
    "output_dim": 80,
    "encoder_channels": 80,
    "decoder_channels": 512,
    "gst_embed_dim": 256,
    "decoder_attention_head_dim": 512,
    "mask_size": [0.1, 0.5],
}
SERENADE_DTYPE = "bfloat16"

# egs/gtsinger/ssc1/conf/vocoder_hifigan.yaml (generator defaults of
# serenade_tpu/vocoder/hifigan.py: in 80, out 1, k7, resblocks 3/7/11 x
# dilations 1/3/5)
VOCODER_CONFIG = {
    "sampling_rate": 24000,
    "num_mels": 80,
    "hop_size": 240,
    "generator_params": {
        "channels": 512,
        "upsample_scales": [8, 6, 5],
        "upsample_kernel_sizes": [16, 12, 10],
    },
}


# egs/gtsinger/ssc1/conf/serenade.yaml, the training keys that
# ``trainers.build_optimizer`` and a training loop read
TRAIN_CONFIG = {
    "batch_size": 4,
    "gradient_accumulate_steps": 1,
    "optimizer_type": "AdamW",
    "optimizer_params": {"lr": 0.0008, "mu_dtype": "bfloat16"},
    "grad_norm": 1.0,
    "scheduler_type": "MultiStepLR",
    "scheduler_params": {"gamma": 0.5,
                         "milestones": [100000, 200000, 300000]},
}


def serenade_config(dtype: str = SERENADE_DTYPE) -> dict:
    """Serenade constructor arguments at full width."""
    return dict(SERENADE_MODEL_PARAMS, dtype=dtype)
