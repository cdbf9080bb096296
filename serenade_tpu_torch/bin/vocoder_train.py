"""Vocoder GAN training on feature dumps (counterpart of
serenade_tpu/bin/vocoder_train.py), with the JAX CLI's flags:

* ``--vocoder-type hifigan`` (default): the mel-conditioned HiFiGAN on
  the ``wave``/``logmel`` pairs of the preprocessing dumps, against the
  multi-scale + multi-period discriminators;
* ``--vocoder-type sifigan``: the source-filter generator on WORLD
  conditioning (the streams stage 9 feeds it, so a trained generator
  drops into ``bin/ssc_postprocessing.py``), against UnivNet's spectral +
  multi-period discriminators, with the source-regularization loss.

``--discriminator-type`` (or the config's ``discriminator_type``)
overrides the adversary.  Config keys: ``generator_params``,
``vocoder_batch_size``, ``segment_frames``, ``lambda_{adv,fm,mel,reg}``,
``gen_lr``, ``disc_lr``, the intervals and ``seed``.  The weights start
from ``init_params_`` with seeds 0 (generator) and 1 (discriminator).

Checkpoints are the port's ``checkpoint-<N>steps`` directories, written
by ``checkpoint.AsyncSaver`` with ``{"generator", "discriminator"}``
under both ``params`` and ``opt_state``; the HiFiGAN run writes identity
``stats.h5`` and ``config.yml`` beside them, so a ``vocoder:`` section
can name the directory.  ``--resume`` restores both networks, both
optimizer states and the segment sampler's state (saved in each
checkpoint's ``meta``), so a resumed run continues the run it resumes
(JAX's CLI restores the parameters alone).  It reads h5 dumps
and a YAML config: h5py and pyyaml, imported where they read.

    python -m serenade_tpu_torch.bin.vocoder_train --train-dumpdir dump \\
        --outdir exp/vocoder --config conf/vocoder_hifigan.yaml
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train a vocoder")
    p.add_argument("--train-dumpdir", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--vocoder-type", choices=("hifigan", "sifigan"),
                   default="hifigan")
    p.add_argument("--discriminator-type", choices=("msd_mpd", "univnet"),
                   default=None,
                   help="adversary; default univnet for sifigan, msd_mpd "
                        "for hifigan (or the config's discriminator_type)")
    p.add_argument("--sifigan-feats-dir", default=None,
                   help="precomputed SiFiGAN streams "
                        "(bin/sifigan_extract_features.py)")
    p.add_argument("--resume", default="",
                   help="a checkpoint directory, or 'latest' under --outdir")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--verbose", type=int, default=1)
    return p


def build_generator(config, vocoder_type: str):
    """(generator, its hop) as JAX's CLI builds them, on the ``conv``
    residual backend."""
    from serenade_tpu_torch.sifigan.generator import SiFiGANGenerator
    from serenade_tpu_torch.vocoder.hifigan import HiFiGANGenerator

    gp = dict(config.get("generator_params", {}))
    sr = int(config.get("sampling_rate", 24000))
    if vocoder_type == "sifigan":
        up = tuple(gp.get("upsample_scales", (5, 4, 3, 2)))
        hop = int(np.prod(up))
        analysis_hop = int(sr * float(config.get("sifigan_shiftms", 5.0))
                           / 1000.0)
        if analysis_hop != hop:
            raise SystemExit(
                f"upsample product {hop} must equal the analysis hop "
                f"{analysis_hop} (sampling_rate * sifigan_shiftms / 1000)")
        mcep_dim = int(config.get("mcep_dim", 39))
        return SiFiGANGenerator(
            in_channels=gp.get("in_channels", mcep_dim + 1 + 3),
            channels=gp.get("channels", 512), upsample_scales=up,
            upsample_kernel_sizes=tuple(
                gp.get("upsample_kernel_sizes", tuple(2 * u for u in up))),
            resblock_backend="conv"), hop
    gen = HiFiGANGenerator(
        in_channels=gp.get("in_channels", config.get("num_mels", 80)),
        channels=gp.get("channels", 512),
        upsample_scales=tuple(gp.get("upsample_scales", (8, 6, 5))),
        upsample_kernel_sizes=tuple(
            gp.get("upsample_kernel_sizes", (16, 12, 10))),
        resblock_backend="conv")
    total_up = int(np.prod(gen.upsample_scales))
    hop = int(config.get("hop_size", 240))
    if total_up != hop:
        raise SystemExit(
            f"generator upsample product {total_up} must equal hop {hop}")
    return gen, hop


def build_discriminator(disc_type: str):
    from serenade_tpu_torch.vocoder.hifigan import (
        MultiScaleMultiPeriodDiscriminator,
    )
    from serenade_tpu_torch.vocoder.univnet import (
        UnivNetMultiResolutionMultiPeriodDiscriminator,
    )

    if disc_type == "univnet":
        return UnivNetMultiResolutionMultiPeriodDiscriminator()
    return MultiScaleMultiPeriodDiscriminator()


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: "
               "%(message)s")

    from serenade_tpu_torch import resolve_device
    from serenade_tpu_torch.checkpoint import (
        AsyncSaver, find_latest_checkpoint, restore_checkpoint,
    )
    from serenade_tpu_torch.config import load_config
    from serenade_tpu_torch.datasets.feats_dataset import FeatsDataset
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.trainers.vocoder_trainer import (
        adamw_chain, batch_to_device, build_vocoder_train_step,
        create_vocoder_state, prepare_sifigan_utterance,
        sample_mel_wav_segments, sample_sifigan_segments, sifigan_forward,
    )

    dev = resolve_device(args.device)
    config = load_config(args.config)
    os.makedirs(args.outdir, exist_ok=True)
    sr = int(config.get("sampling_rate", 24000))
    generator, hop = build_generator(config, args.vocoder_type)
    disc_type = (args.discriminator_type or config.get("discriminator_type")
                 or ("univnet" if args.vocoder_type == "sifigan"
                     else "msd_mpd"))
    discriminator = build_discriminator(disc_type)
    logging.info("discriminator: %s", disc_type)

    dataset = FeatsDataset(args.train_dumpdir, scaler=None)
    seg_frames = int(config.get("segment_frames", 32))
    batch = int(config.get("vocoder_batch_size", 8))
    rng_np = np.random.default_rng(int(config.get("seed", 0)))
    gen_fwd, reg_loss_fn, lambda_reg = None, None, 0.0
    if args.vocoder_type == "sifigan":
        if args.sifigan_feats_dir:
            from serenade_tpu_torch.bin.sifigan_extract_features import (
                load_precomputed,
            )

            items = [it for it in load_precomputed(args.sifigan_feats_dir)
                     if it["c"].shape[0] > seg_frames]
            logging.info("loaded %d precomputed sifigan utterances from %s",
                         len(items), args.sifigan_feats_dir)
        else:
            items = []
            for i in range(len(dataset)):
                prepared = prepare_sifigan_utterance(
                    dataset[i]["wave"], sr,
                    frame_period_ms=float(config.get("sifigan_shiftms", 5.0)),
                    mcep_dim=int(config.get("mcep_dim", 39)),
                    dense_factors=tuple(config.get("dense_factors",
                                                   (0.5, 1, 4, 8))),
                    upsample_scales=generator.upsample_scales, device=dev)
                if prepared is not None and prepared["c"].shape[0] > seg_frames:
                    items.append(prepared)
        if not items:
            raise SystemExit("no usable (voiced, long enough) utterances")

        def sampler():
            return sample_sifigan_segments(
                items, rng_np, batch, seg_frames, hop,
                upsample_scales=generator.upsample_scales)

        # source regularization (the recipe's lambda_reg 1.0)
        lambda_reg = float(config.get("lambda_reg", 1.0))
        gen_fwd = sifigan_forward(generator, with_excitation=lambda_reg > 0)
        if lambda_reg > 0:
            from serenade_tpu_torch.vocoder.losses import residual_loss

            def reg_loss_fn(aux, batch_):
                return residual_loss(aux, batch_["wav"], batch_["cf0"],
                                     sampling_rate=sr, hop_size=hop)
    else:
        items = [dataset[i] for i in range(len(dataset))]

        def sampler():
            return sample_mel_wav_segments(items, rng_np, batch, seg_frames,
                                           hop)
    logging.info("loaded %d utterances", len(items))

    init_params_(generator, 0)
    init_params_(discriminator, 1)
    generator.to(dev).train()
    discriminator.to(dev).train()
    gen_opt = adamw_chain(float(config.get("gen_lr", 2e-4)))
    disc_opt = adamw_chain(float(config.get("disc_lr", 2e-4)))
    state = create_vocoder_state(generator, discriminator, gen_opt, disc_opt)
    step_fn = build_vocoder_train_step(
        generator, discriminator, gen_opt, disc_opt, sampling_rate=sr,
        lambda_adv=float(config.get("lambda_adv", 1.0)),
        lambda_fm=float(config.get("lambda_fm", 2.0)),
        lambda_mel=float(config.get("lambda_mel", 45.0)),
        lambda_reg=lambda_reg, gen_forward=gen_fwd, reg_loss_fn=reg_loss_fn)

    start_step = 0
    if args.resume:
        path = (args.resume if args.resume != "latest"
                else find_latest_checkpoint(args.outdir))
        if path:
            restored = restore_checkpoint(path)
            restore_vocoder_state(state, restored, dev)
            start_step = state.step
            # the sampler where the saved run left it
            rng_np.bit_generator.state = restored["meta"]["sampler_state"]
            logging.info("resumed from %s at step %d", path, start_step)

    max_steps = int(config.get("vocoder_train_max_steps", 50000))
    log_every = int(config.get("log_interval_steps", 100))
    save_every = int(config.get("save_interval_steps", 5000))
    if args.vocoder_type == "hifigan":
        write_identity_stats(args.outdir, config, generator.in_channels)

    saver = AsyncSaver()
    for step in range(start_step, max_steps):
        state, metrics = step_fn(state, batch_to_device(sampler(), dev))
        if (step + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            logging.info("step %d gen %.4f disc %.4f mel %.4f", step + 1,
                         m["train/gen_loss"], m["train/disc_loss"],
                         m["train/mel_loss"])
        if (step + 1) % save_every == 0 or step + 1 == max_steps:
            saver.save(args.outdir, step + 1, *vocoder_checkpoint(state),
                       meta={"sampler_state": rng_np.bit_generator.state})
    saver.wait()
    logging.info("vocoder training finished at %d steps", max_steps)


def vocoder_checkpoint(state):
    """(params, opt_state) of a vocoder checkpoint: each a
    ``{"generator", "discriminator"}`` pair."""
    return ({"generator": dict(state.gen_params),
             "discriminator": dict(state.disc_params)},
            {"generator": state.gen_opt, "discriminator": state.disc_opt})


def restore_vocoder_state(state, restored: dict, dev) -> None:
    """``restored`` (``checkpoint.restore_checkpoint``) into ``state`` in
    place: both networks' parameters, both optimizer states, the step."""
    import torch

    def into(live: dict, saved: dict, what: str):
        if set(live) != set(saved):
            raise KeyError(f"the checkpoint's {what} differs from the live "
                           f"one at {sorted(set(live) ^ set(saved))[:5]}")
        with torch.no_grad():
            for name, t in live.items():
                t.copy_(saved[name])

    for net, params, opt in (("generator", state.gen_params, state.gen_opt),
                             ("discriminator", state.disc_params,
                              state.disc_opt)):
        into(params, restored["params"][net], f"{net} params")
        saved = restored["opt_state"][net]
        opt["count"] = int(saved["count"])
        for moment in ("mu", "nu"):
            into(opt[moment], saved[moment], f"{net} {moment}")
    state.step = int(restored["meta"]["step"])


def write_identity_stats(outdir: str, config, n_mels: int) -> None:
    """Identity ``stats.h5`` (mean 0, scale 1) and the run's
    ``config.yml`` beside the checkpoints: training took raw log-mels, so
    the vocoder's renormalization must be a no-op."""
    import yaml

    from serenade_tpu_torch.utils.h5 import write_hdf5

    stats_path = os.path.join(outdir, "stats.h5")
    write_hdf5(stats_path, "mean", np.zeros(n_mels, np.float32))
    write_hdf5(stats_path, "scale", np.ones(n_mels, np.float32))
    with open(os.path.join(outdir, "config.yml"), "w") as f:
        yaml.safe_dump(dict(config), f)
    logging.info("wrote identity stats.h5 and config.yml beside the "
                 "checkpoints (a vocoder: section can name %s)", outdir)


if __name__ == "__main__":
    main()
