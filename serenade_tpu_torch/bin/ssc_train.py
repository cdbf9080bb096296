"""The training CLI (counterpart of serenade_tpu/bin/ssc_train.py)::

    python -m serenade_tpu_torch.bin.ssc_train \\
        --train-dumpdir dump/train --dev-dumpdir dump/dev \\
        --stats dump/stats.joblib --outdir exp/serenade \\
        --config conf/serenade.yaml [--resume latest] \\
        [--init-checkpoint exp/checkpoint-200000steps.pkl]

The JAX CLI's flags and config surface: the YAML merged with the flags
and written back as ``<outdir>/config.yml``; the dataset, collater,
trainer and model named by the config's ``*_type`` keys; the train keys
the collater declares, ``host_batch_dtype``, ``collater_params``,
``sort_window``, ``num_workers``, ``loader_worker_type``,
``device_resident_data``; ``load_mods`` / ``freeze_mods`` as JAX's flax
path prefixes; checkpoints ``<outdir>/checkpoint-<N>steps``.
``--init-checkpoint`` takes a port checkpoint directory or the upstream
reference's torch ``.pkl`` (converted; its GST then runs its BatchNorm
statistics).  The F0-fluctuation variant trains through its config's
``*New`` types, or through ``bin/ssc_train_new.py``.
Needs h5py, joblib and pyyaml to read the dumps, statistics and config.
Runs on CUDA unless ``--device cpu``.

Parallel layouts run one process a rank (``parallel/``)::

    torchrun --nproc-per-node 2 -m serenade_tpu_torch.bin.ssc_train \
        --data-axis 2 [--zero1] ...        # dp, ZeRO-1 moments
    torchrun --nproc-per-node 2 -m serenade_tpu_torch.bin.ssc_train \
        --model-axis 2 ...                 # tp

The world size must be ``data x model`` (``--data-axis -1`` takes every
rank left).  The global batch is ``batch_size x data``: every rank reads
it in the same seeded order and keeps its rows.  Rank 0 logs, evaluates
and writes the checkpoints, in the one-card layout.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

DEFAULT_DATASET = "FeatsDataset"


def build_argparser():
    p = argparse.ArgumentParser(
        description="train SSC model (PyTorch).  The model's weights start "
                    "from the port's own seeded init (--seed), which is not "
                    "the JAX package's: the two CLIs start from different "
                    "weights for one seed.")
    p.add_argument("--train-dumpdir", required=True)
    p.add_argument("--dev-dumpdir", required=True)
    p.add_argument("--stats", required=True,
                   help="stats.joblib from compute_statistics")
    p.add_argument("--outdir", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--resume", default="", nargs="?",
                   help="checkpoint dir to resume, or 'latest'")
    p.add_argument("--init-checkpoint", "--pretrain", default="", nargs="?",
                   help="checkpoint to load params from (no optimizer "
                        "state): a checkpoint-<N>steps dir or a reference "
                        "torch .pkl")
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--model-axis", type=int, default=1,
                   help="tensor-parallel axis size (ranks)")
    p.add_argument("--data-axis", type=int, default=-1,
                   help="data-parallel axis size (-1 = all remaining "
                        "ranks)")
    p.add_argument("--zero1", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="shard optimizer state over the data axis (ZeRO-1); "
                        "config key 'zero1' sets the default, --no-zero1 "
                        "overrides it off")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--verbose", type=int, default=1)
    return p


def count_parameter_table(params) -> str:
    """Parameter counts per top-level module of a state dict."""
    rows = {}
    for name, t in params.items():
        top = name.split(".")[0]
        rows[top] = rows.get(top, 0) + int(t.numel())
    lines = [f"{'module':<28}{'params':>14}"]
    lines += [f"{k:<28}{rows[k]:>14,}" for k in sorted(rows)]
    lines.append(f"{'TOTAL':<28}{sum(rows.values()):>14,}")
    return "\n".join(lines)


def mesh_axes(data_axis: int, model_axis: int = 1) -> tuple:
    """(data, model) for this launch: the world size must be their
    product (``data_axis`` -1 takes every rank left).  Refused by name
    otherwise, before anything is read."""
    from serenade_tpu_torch.parallel.mesh import world

    size = world()[1]
    data = size // max(model_axis, 1) if data_axis == -1 else data_axis
    if data < 1 or data * model_axis != size:
        raise SystemExit(
            f"--data-axis {data_axis} x --model-axis {model_axis} needs "
            f"{max(data, 1) * model_axis} ranks, but the world has {size}: "
            f"launch one process a rank, e.g. torchrun --nproc-per-node "
            f"{max(data, 1) * model_axis} -m ...")
    return data, model_axis


def _vocoder(config, scaler, device):
    """The eval samples' vocoder from the config's ``vocoder:`` section
    (HiFiGAN or Griffin-Lim), with the logmel scaler as its target
    statistics; None (mel-only samples) where it cannot synthesize."""
    from serenade_tpu_torch.utils.scalers import scaler_dicts
    from serenade_tpu_torch.vocoder.vocoder import vocoder_from_section

    return vocoder_from_section(config.get("vocoder"),
                                scaler_dicts(scaler)["logmel"], device=device)


def main(argv=None, dataset_name: str = DEFAULT_DATASET):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: "
               "%(message)s")

    from serenade_tpu_torch import resolve_device
    from serenade_tpu_torch.api import load_checkpoint_params
    from serenade_tpu_torch.config import dump_config, load_config, resolve
    from serenade_tpu_torch.datasets.loader import ShardedBatchLoader
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.parallel import make_mesh, maybe_init_distributed
    from serenade_tpu_torch.parallel.mesh import world
    from serenade_tpu_torch.parallel.sharding import shard_params
    from serenade_tpu_torch.trainers import (
        build_optimizer, build_train_step, create_train_state,
    )
    from serenade_tpu_torch.trainers.eval_samples import make_eval_fn
    from serenade_tpu_torch.utils.model_io import (
        freeze_mask, transfer_params,
    )
    from serenade_tpu_torch.utils.scalers import load_scalers

    maybe_init_distributed()
    data, model_axis = mesh_axes(args.data_axis, args.model_axis)
    rank = world()[0]
    if rank:
        logging.getLogger().setLevel(logging.WARN)
    config = load_config(args.config)
    config.update({k: v for k, v in vars(args).items()
                   if v not in (None, "")})
    zero1 = (args.zero1 if args.zero1 is not None
             else bool(config.get("zero1", False)))
    dataset_cls = resolve("dataset", config.get("dataset_type",
                                                dataset_name))
    collater_cls = resolve("collater", config.get("collater_type",
                                                  "SSCCollater"))
    trainer_cls = resolve("trainer", config.get("trainer_type",
                                                "SSCTrainer"))
    model_cls = resolve("model", config.get("model_type", "Serenade"))
    dev = resolve_device(args.device)

    # the init checkpoint first: a reference .pkl fixes the GST's norm
    # (its BatchNorm statistics), which config.yml must then record
    model_params = dict(config.get("model_params", {}))
    load_mods = config.get("load-mods") or config.get("load_mods")
    src = None
    if args.init_checkpoint:
        src, ckpt_params = load_checkpoint_params(args.init_checkpoint,
                                                  model_params, model_cls)
        if not load_mods:
            model_params = ckpt_params
    config["model_params"] = model_params
    os.makedirs(args.outdir, exist_ok=True)
    if rank == 0:
        dump_config(config, os.path.join(args.outdir, "config.yml"))

    np.random.seed(args.seed)
    scaler = load_scalers(args.stats)
    # the train collater takes only these streams; the rest are not read
    train_keys = tuple(sorted(set(collater_cls.FEATURE_KEYS.values())))
    common = dict(scaler=scaler,
                  score_type=config.get("score_type", "est_lf0_score"),
                  logmel_type=config.get("logmel_type", "logmel"))
    train_dataset = dataset_cls(
        args.train_dumpdir, allow_cache=config.get("allow_cache", False),
        load_keys=train_keys, **common)
    # original dev dumps carry no cyclic key: their target is their mel
    dev_dataset = dataset_cls(args.dev_dumpdir, logmel_fallback=True,
                              **common)
    collater_kwargs = dict(config.get("collater_params") or {})
    if config.get("host_batch_dtype"):
        collater_kwargs["host_dtype"] = config["host_batch_dtype"]
    batch_size = int(config.get("batch_size", 4))
    # every rank reads the global batch in one seeded order, then keeps
    # its rows (the trainer's shard_batch)
    global_batch = batch_size * data
    train_loader = ShardedBatchLoader(
        train_dataset, collater_cls(**collater_kwargs),
        batch_size=global_batch, shuffle=True, seed=args.seed,
        num_workers=int(config.get("num_workers", 0)),
        worker_type=config.get("loader_worker_type", "thread"),
        sort_window=int(config.get("sort_window", 0)))
    logging.info("dataset: %d train / %d dev; global batch %d on %s, "
                 "mesh data=%d x model=%d%s", len(train_dataset),
                 len(dev_dataset), global_batch, dev, data, model_axis,
                 " (ZeRO-1)" if zero1 and data > 1 else "")

    model = init_params_(model_cls(**model_params), seed=args.seed)
    logging.info("\n%s", count_parameter_table(model.state_dict()))
    if src is not None:
        model.load_state_dict(transfer_params(model, src, load_mods)
                              if load_mods else src)
        logging.info("initialized params from %s", args.init_checkpoint)
    trainable = None
    freeze = config.get("freeze-mods") or config.get("freeze_mods")
    if freeze:
        trainable = freeze_mask(model, freeze)
        logging.info("froze modules: %s", freeze)
    model.to(dev)
    opt, _ = build_optimizer(config, trainable_mask=trainable)
    layout = None
    if data * model_axis > 1:
        layout = shard_params(model, make_mesh(data, model_axis),
                              zero1=zero1)
    state = create_train_state(model, opt, layout)
    # as in the JAX CLI, gradient_accumulate_steps is not passed
    step_fn = build_train_step(
        model, opt,
        prior_loss_start_steps=int(config.get("prior_loss_start_steps", 0)),
        device=dev)

    train_iter = train_loader
    if config.get("device_resident_data"):
        from serenade_tpu_torch.datasets.device_cache import (
            DeviceResidentData,
        )

        pft = int((config.get("collater_params") or {}).get(
            "pad_frames_to") or 0)
        if not pft:
            raise ValueError("device_resident_data requires "
                             "collater_params.pad_frames_to")
        dr = DeviceResidentData(train_dataset, pad_frames_to=pft,
                                batch_size=global_batch, seed=args.seed,
                                device=dev)
        train_iter = dr
        step_fn = dr.wrap_step(step_fn)
        train_loader.shutdown()
        logging.info("device-resident training data: a step uploads its "
                     "indices")

    # the eval's one dev batch, in f32
    first_batch = next(iter(ShardedBatchLoader(
        dev_dataset, collater_cls(),
        batch_size=min(global_batch, len(dev_dataset)), shuffle=False,
        drop_last=False)))
    eval_fn = make_eval_fn(
        model, first_batch, outdir=args.outdir,
        vocoder=_vocoder(config, scaler, dev),
        num_save=int(config.get("num_save_intermediate_results", 8)),
        device=dev)
    trainer = trainer_cls(
        config=config, train_step=step_fn, state=state,
        train_iter=train_iter, outdir=args.outdir, eval_fn=eval_fn,
        generator=torch.Generator(device=dev).manual_seed(args.seed + 2))
    if args.resume:
        trainer.resume(args.resume if args.resume != "latest" else None)
    try:
        trainer.run()
    finally:
        train_loader.shutdown()


if __name__ == "__main__":
    main()
