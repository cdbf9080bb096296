"""Full-width configurations, carried as dicts so the port reads no YAML.
``tests/test_torch_slice.py`` holds them equal to the recipe files they
cite."""

from __future__ import annotations

# egs/gtsinger/ssc1/conf/serenade.yaml feature extraction (the keys
# ``features.FeatureConfig`` reads; a server also converts frames to audio
# seconds by them)
FEATURE_CONFIG = {"sampling_rate": 24000, "fft_size": 512, "hop_size": 240,
                  "win_length": 480, "shiftms": 10, "eps": 1.0e-6,
                  "window": "hann", "num_mels": 80, "fmin": 63,
                  "fmax": 12000}

# ContentVec at the width the JAX package builds it for feature
# extraction (``ContentVecEncoder()`` in serenade_tpu/bin/preprocess.py:
# HuBERT base, 12 layers of 768, the last conv at stride 1)
CONTENTVEC_CONFIG = {"dim": 768, "num_layers": 12, "heads": 12,
                     "ffn_dim": 3072, "last_conv_stride": 1,
                     "pos_conv_kernel": 128, "pos_conv_groups": 16}

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

# egs/gtsinger/ssc1/conf/vocoder_griffin_lim.yaml: the checkpoint-free
# vocoder of the full-budget configs (serenade_fullbudget.yaml:33)
GRIFFIN_LIM_CONFIG = {
    "sampling_rate": 24000,
    "generator_type": "GriffinLim",
    "generator_params": {"fft_size": 512, "hop_size": 240, "win_length": 480,
                         "num_mels": 80, "fmin": 63, "fmax": 12000,
                         "n_iter": 32, "log_base": 10.0},
}

# the training keys of egs/gtsinger/ssc1/conf/vocoder_hifigan.yaml and
# vocoder_sifigan.yaml that ``bin/vocoder_train.py`` reads
VOCODER_TRAIN_CONFIG = dict(
    VOCODER_CONFIG, segment_frames=32, vocoder_batch_size=16, gen_lr=2.0e-4,
    disc_lr=2.0e-4, lambda_adv=1.0, lambda_fm=2.0, lambda_mel=45.0,
    vocoder_train_max_steps=500000, log_interval_steps=100,
    save_interval_steps=10000, seed=0)
SIFIGAN_TRAIN_CONFIG = {
    "sampling_rate": 24000, "sifigan_shiftms": 5.0, "mcep_dim": 39,
    "dense_factors": [0.5, 1, 4, 8],
    "generator_params": {"channels": 512, "in_channels": 43,
                         "upsample_scales": [5, 4, 3, 2],
                         "upsample_kernel_sizes": [10, 8, 6, 4]},
    "segment_frames": 32, "vocoder_batch_size": 16, "gen_lr": 2.0e-4,
    "disc_lr": 2.0e-4, "discriminator_type": "univnet", "lambda_adv": 1.0,
    "lambda_fm": 2.0, "lambda_mel": 45.0, "lambda_reg": 1.0,
    "vocoder_train_max_steps": 500000, "log_interval_steps": 100,
    "save_interval_steps": 10000, "seed": 0}


# egs/gtsinger/ssc1/conf/serenade.yaml, the training keys that
# ``trainers.build_optimizer`` and ``trainers.SSCTrainer`` read
TRAIN_CONFIG = {
    "batch_size": 4,
    "gradient_accumulate_steps": 1,
    "optimizer_type": "AdamW",
    "optimizer_params": {"lr": 0.0008, "mu_dtype": "bfloat16"},
    "grad_norm": 1.0,
    "scheduler_type": "MultiStepLR",
    "scheduler_params": {"gamma": 0.5,
                         "milestones": [100000, 200000, 300000]},
    "train_max_steps": 40000,
    "save_interval_steps": 2500,
    "eval_interval_steps": 2500,
    "log_interval_steps": 500,
    "num_save_intermediate_results": 8,
}

# egs/gtsinger/ssc1/conf/serenade_fullbudget.yaml: batch 16, every batch
# padded to 1280 frames, the corpus resident on the device
TRAIN_CONFIG_FULLBUDGET = dict(
    TRAIN_CONFIG, batch_size=16, collater_params={"pad_frames_to": 1280},
    device_resident_data=True)


def serenade_config(dtype: str = SERENADE_DTYPE) -> dict:
    """Serenade constructor arguments at full width."""
    return dict(SERENADE_MODEL_PARAMS, dtype=dtype)
