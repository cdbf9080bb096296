"""The distillation CLI (counterpart of serenade_tpu/bin/distill.py)::

    python -m serenade_tpu_torch.bin.distill \\
        --teacher-checkpoint exp/serenade/checkpoint-40000steps \\
        --config exp/serenade/config.yml \\
        --train-dumpdir dump/train/norm --stats dump/stats.joblib \\
        --outdir exp/serenade_distilled --distill-steps 2000

Fine-tunes the CFM estimator of a trained checkpoint against its own ODE
endpoints (``trainers/distill.py``: ``--mode endpoint`` regresses the
student's ``--student-steps`` Euler rollout onto the teacher's
endpoint, ``--mode reflow`` straightens the field for any step count).
It writes ``<outdir>/config.yml`` with ``distilled: true`` and
``inference_n_timesteps`` set to ``--student-steps``, and port checkpoints
``<outdir>/checkpoint-<N>steps``, which ``ssc_decode`` and ``serve
--expdir`` read and then sample with that many steps.

``--teacher-checkpoint`` is a port ``checkpoint-<N>steps`` directory (an
Orbax directory of the JAX package is refused by name).  The dataset,
collater, trainer and model resolve from the config, so the ``*New``
types distill with ``f0_fluc``.  ``--data-axis N`` distils data-parallel
over ``N`` ranks (``torchrun --nproc-per-node N``; the teacher's
parameters replicated, the global batch ``batch_size x N``, rank 0
writing), as ``bin/ssc_train.py`` trains.

Two parts: :func:`distill_core` distills from a config dict, a teacher
state dict and batches (a loader, or ``datasets.device_cache.
DeviceResidentData``; torch and numpy only), and :func:`main` reads the
dump, the statistics and the config (``h5py``, ``joblib``, ``pyyaml``)
and writes the config.  Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch


def build_argparser():
    p = argparse.ArgumentParser(
        description="distill a trained SSC model to few-step sampling "
                    "(PyTorch)")
    p.add_argument("--teacher-checkpoint", required=True,
                   help="trained checkpoint-<N>steps directory of the port")
    p.add_argument("--config", required=True,
                   help="teacher config.yml (beside the checkpoint)")
    p.add_argument("--train-dumpdir", required=True)
    p.add_argument("--stats", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--distill-steps", type=int, default=2000)
    p.add_argument("--teacher-steps", type=int, default=10,
                   help="teacher ODE steps per pair (reference sampler: 10)")
    p.add_argument("--mode", default="endpoint",
                   choices=("endpoint", "reflow"),
                   help="'endpoint' (default) regresses the student's own "
                        "k-step Euler rollout onto the teacher endpoint, "
                        "for the fixed --student-steps k; 'reflow' "
                        "straightens the field for any step count "
                        "(rectified flow)")
    p.add_argument("--solver", default="euler",
                   help="teacher ODE solver for pair generation")
    p.add_argument("--temperature", type=float, default=0.667)
    p.add_argument("--student-steps", type=int, default=2,
                   help="deployed Euler step count: endpoint mode distills "
                        "exactly this rollout, and the dumped config makes "
                        "it decode's default n_timesteps")
    p.add_argument("--lr", type=float, default=1e-4,
                   help="distillation fine-tune LR (teacher trained at 8e-4)")
    p.add_argument("--batch-size", type=int, default=0,
                   help="0 = teacher config's batch_size")
    p.add_argument("--data-axis", type=int, default=-1,
                   help="data-parallel axis size (-1 = all ranks)")
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--verbose", type=int, default=1)
    return p


def distill_config(config: Mapping[str, Any], *, distill_steps: int,
                   lr: float, student_steps: int, mode: str,
                   teacher_steps: int, solver: str) -> Dict[str, Any]:
    """The distilled run's config: the teacher's with
    ``distill_config_overrides``, AdamW at ``lr`` (the teacher's other
    optimizer parameters kept), a constant rate, and the JAX CLI's
    intervals (a log every tenth of the run at most, saves at its half and
    end, no eval)."""
    from serenade_tpu_torch.trainers.distill import distill_config_overrides

    out = distill_config_overrides(dict(config))
    out.update({
        "train_max_steps": distill_steps,
        "optimizer_type": "AdamW",
        "optimizer_params": {"lr": lr, **{
            k: v for k, v in config.get("optimizer_params", {}).items()
            if k != "lr"}},
        "scheduler_type": "ConstantLR",
        "scheduler_params": {},
        "inference_n_timesteps": student_steps,
        "distill_mode": mode,
        "distill_teacher_steps": teacher_steps,
        "distill_solver": solver,
        "log_interval_steps": min(int(config.get("log_interval_steps", 500)),
                                  max(distill_steps // 10, 1)),
        "save_interval_steps": max(distill_steps // 2, 1),
        "eval_interval_steps": distill_steps + 1,
    })
    return out


def distill_core(config: Mapping[str, Any],
                 teacher_params: Mapping[str, torch.Tensor], train_iter, *,
                 outdir: str, mode: str = "endpoint", student_steps: int = 2,
                 teacher_steps: int = 10, solver: str = "euler",
                 temperature: float = 0.667, seed: int = 777, device=None,
                 writer=None, mesh=None):
    """Distill ``teacher_params`` (a state dict of the config's model)
    over ``train_iter`` (collated batches, or a ``DeviceResidentData``,
    whose step gathers on the device) to ``config["train_max_steps"]``
    under the config's trainer, checkpoints in ``outdir``.  ``config`` is
    the distilled run's (:func:`distill_config`).  Under a rank ``mesh``
    (``parallel.make_mesh``) the student trains data-parallel over its
    ``data`` axis and ``train_iter`` yields global batches.  Returns (the
    trainer, whose ``state.params`` are the student's, the frozen
    teacher)."""
    from serenade_tpu_torch import resolve_device
    from serenade_tpu_torch.config import resolve
    from serenade_tpu_torch.trainers import (
        build_optimizer, create_train_state,
    )
    from serenade_tpu_torch.trainers.distill import (
        build_distill_step, distill_trainable_mask, frozen_teacher,
    )

    dev = resolve_device(device)
    model_cls = resolve("model", config.get("model_type", "Serenade"))
    trainer_cls = resolve("trainer", config.get("trainer_type",
                                                "SSCTrainer"))
    model_params = dict(config.get("model_params", {}))

    def built():
        model = model_cls(**model_params)
        model.load_state_dict(teacher_params)
        return model.to(dev)

    # the student starts at the teacher but shares no storage with it: the
    # optimizer's in-place updates must never reach the teacher
    teacher = frozen_teacher(built())
    student = built()
    opt, _ = build_optimizer(config,
                             trainable_mask=distill_trainable_mask(student))
    layout = None
    if mesh is not None and mesh.size > 1:
        from serenade_tpu_torch.parallel.sharding import shard_params

        layout = shard_params(student, mesh)
    state = create_train_state(student, opt, layout)
    step_fn = build_distill_step(
        student, teacher, opt, mode=mode, student_steps=student_steps,
        n_teacher_steps=teacher_steps, solver=solver,
        temperature=temperature, device=dev)
    if hasattr(train_iter, "wrap_step"):
        step_fn = train_iter.wrap_step(step_fn)
    trainer = trainer_cls(
        config=dict(config), train_step=step_fn, state=state,
        train_iter=train_iter, writer=writer, outdir=outdir,
        generator=torch.Generator(device=dev).manual_seed(seed + 2))
    trainer.run()
    logging.info("distilled checkpoint in %s; its config defaults "
                 "n_timesteps to %d", outdir, student_steps)
    return trainer, teacher


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: "
               "%(message)s")
    from serenade_tpu_torch.bin.ssc_train import mesh_axes
    from serenade_tpu_torch.parallel import make_mesh, maybe_init_distributed
    from serenade_tpu_torch.parallel.mesh import world

    maybe_init_distributed()
    data, _ = mesh_axes(args.data_axis)
    rank = world()[0]
    if rank:
        logging.getLogger().setLevel(logging.WARN)

    from serenade_tpu_torch.checkpoint import restore_params_only
    from serenade_tpu_torch.config import dump_config, load_config, resolve
    from serenade_tpu_torch.datasets.loader import ShardedBatchLoader
    from serenade_tpu_torch.utils.scalers import load_scalers

    config = load_config(args.config)
    os.makedirs(args.outdir, exist_ok=True)
    np.random.seed(args.seed)
    scaler = load_scalers(args.stats)
    dataset_cls = resolve("dataset", config.get("dataset_type",
                                                "FeatsDataset"))
    collater_cls = resolve("collater", config.get("collater_type",
                                                  "SSCCollater"))
    dataset = dataset_cls(
        args.train_dumpdir, scaler=scaler,
        score_type=config.get("score_type", "est_lf0_score"),
        logmel_type=config.get("logmel_type", "logmel"),
        allow_cache=config.get("allow_cache", False),
        load_keys=tuple(sorted(set(collater_cls.FEATURE_KEYS.values()))))
    batch_size = args.batch_size or int(config.get("batch_size", 4))
    loader = ShardedBatchLoader(dataset, collater_cls(),
                                batch_size=batch_size * data, shuffle=True,
                                seed=args.seed)
    logging.info("distilling from %s over %d utterances (batch %d)",
                 args.teacher_checkpoint, len(dataset), batch_size)
    teacher_params = restore_params_only(args.teacher_checkpoint)
    run_config = distill_config(
        config, distill_steps=args.distill_steps, lr=args.lr,
        student_steps=args.student_steps, mode=args.mode,
        teacher_steps=args.teacher_steps, solver=args.solver)
    if rank == 0:
        dump_config(run_config, os.path.join(args.outdir, "config.yml"))
    try:
        distill_core(run_config, teacher_params, loader, outdir=args.outdir,
                     mode=args.mode, student_steps=args.student_steps,
                     teacher_steps=args.teacher_steps, solver=args.solver,
                     temperature=args.temperature, seed=args.seed,
                     device=args.device,
                     mesh=make_mesh(data, 1) if data > 1 else None)
    finally:
        loader.shutdown()


if __name__ == "__main__":
    main()
