"""The ranks of the port's parallel tests: one spawned process a rank in a
gloo group on a ``file://`` store, running every scenario of one test file
on the inputs the test wrote and writing each rank's results for it to
read (``tests/test_torch_{parallel,pipeline,moe}.py``).

Imports torch and the port only: JAX stays in the test process.
"""

from __future__ import annotations

import datetime
import fcntl
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist


def _np(t):
    return t.detach().cpu().float().numpy()


def _init(rank, world, store):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120))


# --- test_torch_parallel: dp, tp, ZeRO-1, checkpoints, cp, the CLIs -------


class Toy(torch.nn.Module):
    """JAX's toy of tests/test_parallel.py: ``w1`` (64, 1024) and ``w2``
    (1024, 64) as Dense layers, loss mean((tanh(x w1) w2 - x)^2) over the
    global batch."""

    def __init__(self, w1, w2):
        super().__init__()
        from serenade_tpu_torch.models.layers import Dense

        self.w1 = Dense(64, 1024, bias=False)
        self.w2 = Dense(1024, 64, bias=False)
        with torch.no_grad():
            self.w1.weight.copy_(torch.from_numpy(w1).T)
            self.w2.weight.copy_(torch.from_numpy(w2).T)

    def forward(self, x, *_, **__):
        from serenade_tpu_torch.parallel.mesh import batch_sum

        err = torch.square(self.w2(torch.tanh(self.w1(x))) - x)
        loss = err.sum() / batch_sum(torch.tensor(float(err.numel())))
        return {"cfm_loss": loss, "prior_loss": loss * 0.0, "loss": loss}


def _toy_batch(x):
    b = x.shape[0]
    return {"x": torch.from_numpy(x), "lengths": torch.zeros(b),
            "logmel": torch.zeros(b), "midi": torch.zeros(b),
            "loud": torch.zeros(b)}


def _toy_run(inp, data, model_axis, *, zero1=False, config=None, steps=5):
    from serenade_tpu_torch.parallel import make_mesh, shard_batch
    from serenade_tpu_torch.parallel.sharding import shard_params
    from serenade_tpu_torch.trainers import (
        build_optimizer, build_train_step, create_train_state,
    )

    mesh = make_mesh(data, model_axis)
    model = Toy(inp["w1"], inp["w2"])
    opt, _ = build_optimizer(config or inp["config"])
    layout = shard_params(model, mesh, zero1=zero1)
    state = create_train_state(model, opt, layout)
    step = build_train_step(model, opt, device="cpu")
    batch = shard_batch(_toy_batch(inp["x"]), mesh)
    for _ in range(steps):
        state, metrics = step(state, batch)
    return mesh, model, layout, state, float(metrics["train/loss"])


def _moment_report(layout, state):
    """Each trainable leaf's moment elements on this rank and in all."""
    full = layout.full_opt_state(state.opt_state)
    return {n: (state.opt_state["mu"][n].numel(), full["mu"][n].numel(),
                str(state.opt_state["mu"][n].dtype))
            for n in state.opt_state["mu"]}


def scenario_toy(inp, rank, world):
    out = {}
    # dp: 4 ranks, 5 AdamW steps
    _, _, layout, state, loss = _toy_run(inp, 4, 1)
    out["dp"] = {"loss": loss, "params": {
        k: _np(v) for k, v in layout.full_params(state.params).items()}}
    # tp: data 2 x model 2; w1 split on its output features
    _, _, layout, state, loss = _toy_run(inp, 2, 2)
    out["tp"] = {"loss": loss, "tp": dict(layout.tp),
                 "local": {k: tuple(v.shape)
                           for k, v in state.params.items()},
                 "params": {k: _np(v) for k, v in
                            layout.full_params(state.params).items()}}
    # ZeRO-1 on data 2 x model 2
    _, _, layout, state, loss = _toy_run(inp, 2, 2, zero1=True)
    out["zero1"] = {"loss": loss, "z1": dict(layout.z1),
                    "moments": _moment_report(layout, state),
                    "params": {k: _np(v) for k, v in
                               layout.full_params(state.params).items()}}
    # bf16 first moments under ZeRO-1 on data 4, 3 steps
    _, _, layout, state, loss = _toy_run(
        inp, 4, 1, zero1=True, config=inp["config_bf16"], steps=3)
    out["bf16"] = {"loss": loss, "moments": _moment_report(layout, state),
                   "params": {k: _np(v) for k, v in
                              layout.full_params(state.params).items()}}
    return out


def scenario_full_model(inp, rank, world):
    """The full Serenade step on data 2 x model 2, uneven lengths, SGD,
    JAX's draws for the global batch."""
    from serenade_tpu_torch.models.serenade import Serenade
    from serenade_tpu_torch.parallel import make_mesh, shard_batch
    from serenade_tpu_torch.parallel.sharding import shard_params
    from serenade_tpu_torch.trainers import (
        build_optimizer, build_train_step, create_train_state,
    )

    mesh = make_mesh(2, 2)
    model = Serenade(**inp["model_cfg"], dtype="float32")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in inp["model_sd"].items()})
    opt, _ = build_optimizer(inp["sgd"])
    layout = shard_params(model, mesh)
    state = create_train_state(model, opt, layout)
    step = build_train_step(model, opt, device="cpu")
    batch = shard_batch({k: torch.from_numpy(v)
                         for k, v in inp["batch"].items()}, mesh)
    draws = {k: torch.from_numpy(np.asarray(v))
             for k, v in inp["draws"].items()}
    losses = []
    for _ in range(2):
        state, metrics = step(state, batch, None, draws=draws)
        losses.append(float(metrics["train/loss"]))
    return {"losses": losses, "tp": sorted(layout.tp),
            "params": {k: _np(v) for k, v in
                       layout.full_params(state.params).items()}}


def _trainer(state, step, outdir):
    from serenade_tpu_torch.trainers.ssc import SSCTrainer

    return SSCTrainer(config={"async_checkpointing": True},
                      train_step=step, state=state, train_iter=[],
                      outdir=outdir)


def scenario_checkpoints(inp, rank, world):
    """ZeRO-1 state saved and restored onto its layout; a tp state saved
    and restored onto data 4 x model 1, which then steps on."""
    from serenade_tpu_torch.parallel import make_mesh, shard_batch
    from serenade_tpu_torch.parallel.sharding import shard_params
    from serenade_tpu_torch.trainers import (
        build_optimizer, build_train_step, create_train_state,
    )

    out = {}
    root = inp["ckpt_dir"]
    # ZeRO-1 round trip
    _, model, layout, state, _ = _toy_run(inp, 2, 2, zero1=True, steps=2)
    tr = _trainer(state, None, os.path.join(root, "zero1"))
    tr.save(2)
    tr.wait_for_saves()
    dist.barrier()
    fresh = Toy(inp["w1"], inp["w2"])
    opt, _ = build_optimizer(inp["config"])
    lay2 = shard_params(fresh, make_mesh(2, 2), zero1=True)
    st2 = create_train_state(fresh, opt, lay2)
    _trainer(st2, None, os.path.join(root, "zero1")).resume()
    out["zero1_equal"] = all(
        torch.equal(st2.opt_state[k][n], state.opt_state[k][n])
        for k in ("mu", "nu") for n in state.opt_state[k])
    out["zero1_shapes"] = {n: tuple(t.shape)
                           for n, t in st2.opt_state["mu"].items()}
    out["zero1_step"] = st2.step
    # tp -> dp reshard
    _, model, layout, state, _ = _toy_run(inp, 2, 2, steps=2)
    saved = {k: v.clone() for k, v in
             layout.full_params(state.params).items()}
    tr = _trainer(state, None, os.path.join(root, "tp"))
    tr.save(2)
    tr.wait_for_saves()
    dist.barrier()
    fresh = Toy(inp["w1"], inp["w2"])
    mesh = make_mesh(4, 1)
    lay3 = shard_params(fresh, mesh)
    st3 = create_train_state(fresh, opt, lay3)
    step = build_train_step(fresh, opt, device="cpu")
    _trainer(st3, step, os.path.join(root, "tp")).resume()
    out["reshard_equal"] = all(torch.equal(st3.params[k], saved[k])
                               for k in saved)
    out["reshard_step"] = st3.step
    st3, metrics = step(st3, shard_batch(_toy_batch(inp["x"]), mesh))
    out["reshard_loss"] = float(metrics["train/loss"])
    return out


def scenario_seq_attention(inp, rank, world):
    from serenade_tpu_torch.ops.attention import seq_sharded_attention
    from serenade_tpu_torch.parallel.mesh import rank_mesh

    mesh = rank_mesh((world,), ("seq",))
    q = torch.from_numpy(inp["q"])
    t = q.shape[1] // world
    got = seq_sharded_attention(
        q[:, rank * t:(rank + 1) * t], torch.from_numpy(inp["k"]),
        torch.from_numpy(inp["v"]), num_heads=inp["heads"], mesh=mesh,
        key_mask=torch.from_numpy(inp["mask"]))
    return {"out": _np(got)}


def scenario_clis(inp, rank, world):
    """The CLIs on 2 of the ranks: train with --data-axis 2 --zero1, with
    --model-axis 2, then distil the first run's checkpoint with
    --data-axis 2."""
    from serenade_tpu_torch.bin import distill as pdistill
    from serenade_tpu_torch.bin import ssc_train as ptrain

    dist.destroy_process_group()
    if rank >= 2:
        return {}
    _init(rank, 2, inp["cli_store"])
    for argv in inp["train_argvs"]:
        ptrain.main(argv)
        dist.barrier()
    pdistill.main(inp["distill_argv"])
    dist.barrier()
    return {"done": True}


# --- test_torch_pipeline: gpipe and the composed step ---------------------


def _stacked(inp, key):
    return {k: torch.from_numpy(v) for k, v in inp[key].items()}


def _toy_stage(p, a):
    return torch.tanh(a @ p["w"] + p["b"])


def _sqrt_stage(p, a):
    return torch.sqrt(torch.abs(a @ p["w"]))


def scenario_gpipe(inp, rank, world):
    from serenade_tpu_torch.parallel import comm
    from serenade_tpu_torch.parallel.pipeline import (
        gpipe, microbatch, pipeline_mesh, place_pipeline_params,
    )

    out = {}
    mesh4 = pipeline_mesh(pipe=4)
    if mesh4.member:
        placed = place_pipeline_params(_stacked(inp, "stages_fwd"), mesh4)
        out["placed_shape"] = tuple(placed["w"].shape)
        x = torch.from_numpy(inp["x_fwd"])
        out["forward"] = _np(gpipe(_toy_stage, placed, microbatch(x, 4),
                                   mesh4))
        # gradients through the schedule, summed over the stages
        stacked = {k: v.requires_grad_() for k, v in
                   _stacked(inp, "stages_grad").items()}
        xg = torch.from_numpy(inp["x_grad"]).requires_grad_()
        y = gpipe(_toy_stage, stacked, microbatch(xg, 4), mesh4)
        loss = torch.mean((y.reshape(xg.shape)
                           - torch.from_numpy(inp["tgt_grad"])) ** 2)
        loss.backward()
        group = mesh4.group("pipe")
        out["grad_loss"] = float(loss)
        out["grads"] = {k: _np(comm.all_reduce_(v.grad.clone(), group))
                        for k, v in stacked.items()}
        out["grad_x"] = _np(comm.all_reduce_(xg.grad.clone(), group))
        # M < S
        placed = place_pipeline_params(_stacked(inp, "stages_few"), mesh4)
        out["few"] = _np(gpipe(_toy_stage, placed,
                               torch.from_numpy(inp["x_few"]), mesh4))
        # a stage with an unbounded derivative at 0
        sq = place_pipeline_params(_stacked(inp, "stages_sqrt"), mesh4)
        for v in sq.values():
            v.requires_grad_()
        xs = microbatch(torch.from_numpy(inp["x_sqrt"]), 4)
        y = gpipe(_sqrt_stage, sq, xs, mesh4)
        torch.sum(y ** 2).backward()
        out["sqrt_forward"] = _np(y)
        out["sqrt_grads_finite"] = bool(all(
            v.grad is None or torch.isfinite(v.grad).all()
            for v in sq.values()))
        # the transformer stack as stages
        from serenade_tpu_torch.models.transformer import (
            BasicTransformerBlock,
        )

        block = BasicTransformerBlock(dim=16, num_attention_heads=2,
                                      attention_head_dim=8,
                                      activation_fn="gelu")
        placed = place_pipeline_params(_stacked(inp, "stages_block"), mesh4)

        def block_stage(p, a):
            return torch.func.functional_call(block, p, (a,))

        out["block"] = _np(gpipe(block_stage, placed, microbatch(
            torch.from_numpy(inp["x_block"]), 4), mesh4))
    # dp x pp on all 8 ranks
    mesh8 = pipeline_mesh(pipe=4, data=2)
    placed = place_pipeline_params(_stacked(inp, "stages_dp"), mesh8)
    out["dp"] = _np(gpipe(_toy_stage, placed, microbatch(
        torch.from_numpy(inp["x_dp"]), 4), mesh8, data_axis="data"))
    return out


def scenario_composed(inp, rank, world):
    from serenade_tpu_torch.parallel import comm, composed_mesh
    from serenade_tpu_torch.parallel.composed import (
        build_composed_step, ffn_stage_tp, place_composed_params,
        stage_param_specs,
    )
    from serenade_tpu_torch.parallel.pipeline import gpipe, microbatch
    import functools

    mesh = composed_mesh(data=2, model=2, pipe=2)
    stacked = _stacked(inp, "composed_stages")
    x = torch.from_numpy(inp["composed_x"])
    stage_fn = functools.partial(ffn_stage_tp,
                                 model_group=mesh.group("model"))
    out = {}
    placed = place_composed_params(stacked, mesh)
    out["local_shapes"] = {k: tuple(v.shape) for k, v in placed.items()}
    out["forward"] = _np(gpipe(stage_fn, placed, microbatch(x, 4), mesh,
                               data_axis="data"))
    # gradients, put back together: model shards gathered, data summed,
    # stages gathered
    for v in placed.values():
        v.requires_grad_()
    y = gpipe(stage_fn, placed, microbatch(x, 4), mesh, data_axis="data")
    target = torch.from_numpy(inp["composed_target"])
    torch.mean((y.reshape(x.shape) - target) ** 2).backward()
    grads = {}
    for k, spec in stage_param_specs().items():
        g = comm.all_reduce_(placed[k].grad.clone(), mesh.group("data"))
        if "model" in spec:
            g = comm.gather_dim(g, mesh.group("model"),
                                list(spec).index("model"))
        grads[k] = _np(comm.gather_dim(g, mesh.group("pipe"), 0))
    out["grads"] = grads
    # three Adam steps
    stage = place_composed_params(stacked, mesh)
    for v in stage.values():
        v.requires_grad_()
    opt, step_fn = build_composed_step(mesh, lr=1e-2)
    opt_state = opt.init(stage)
    tgt = microbatch(torch.from_numpy(inp["composed_target3"]), 4)
    out["losses"] = [float(step_fn(stage, opt_state, microbatch(x, 4), tgt))
                     for _ in range(3)]
    out["after_shapes"] = {k: tuple(v.shape) for k, v in stage.items()}
    out["moment_shapes"] = {k: tuple(v.shape)
                            for k, v in opt_state["mu"].items()}
    return out


# --- test_torch_moe: expert parallelism ------------------------------------


def scenario_moe(inp, rank, world):
    from serenade_tpu_torch.parallel import comm
    from serenade_tpu_torch.parallel.moe import (
        expert_mesh, moe_ffn, place_moe_params,
    )

    mesh = expert_mesh(expert=2, data=2)
    params = {k: torch.from_numpy(v) for k, v in inp["params"].items()}
    placed = place_moe_params(params, mesh)
    for v in placed.values():
        v.requires_grad_()
    x = torch.from_numpy(inp["x"])
    y, aux = moe_ffn(placed, x, capacity_factor=2.0, mesh=mesh)
    (torch.sum(y ** 2) + 0.01 * aux).backward()
    everyone = [mesh.group("expert"), mesh.group("data")]
    router = placed["router"].grad.clone()
    for g in everyone:
        comm.all_reduce_(router, g)
    experts = {}
    for k in ("wi", "wo"):
        # each expert's gradient sums over the data ranks' tokens
        g = comm.all_reduce_(placed[k].grad.clone(), mesh.group("data"))
        experts[k] = _np(comm.gather_dim(g, mesh.group("expert"), 0))
    return {"y": _np(y), "aux": float(aux),
            "local": {k: tuple(v.shape) for k, v in placed.items()},
            "grad_router": _np(router), "grads": experts}


SCENARIOS = {
    "parallel": (scenario_toy, scenario_full_model, scenario_checkpoints,
                 scenario_seq_attention, scenario_clis),
    "pipeline": (scenario_gpipe, scenario_composed),
    "moe": (scenario_moe,),
}


def main(rank, world, store, suite, inp_path, outdir):
    """Run ``suite``'s scenarios in order; each rank writes
    ``<outdir>/rank<r>.pt`` with every scenario's results, or the
    traceback of the one that failed."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    _init(rank, world, store)
    inp = torch.load(inp_path, weights_only=False)
    results = {}
    try:
        for fn in SCENARIOS[suite]:
            results[fn.__name__] = fn(inp, rank, world)
    except BaseException:
        results["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(results, os.path.join(outdir, f"rank{rank}.pt"))
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(suite, world, root, inp):
    """Start ``world`` ranks of ``suite`` on inputs ``inp`` under the
    directory ``root``; returns the processes for :func:`collect`."""
    import multiprocessing

    torch.save(inp, os.path.join(root, "inp.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=main, args=(
        r, world, os.path.join(root, "store"), suite,
        os.path.join(root, "inp.pt"), root)) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def collect(procs, root, timeout=600):
    """Every rank's results; stops the others as soon as one rank fails
    (they would wait in a collective) or at ``timeout`` seconds, and
    raises with the first traceback."""
    import time

    deadline = time.monotonic() + timeout
    while any(p.is_alive() for p in procs):
        failed = any(p.exitcode not in (None, 0) for p in procs)
        if failed or time.monotonic() > deadline:
            for p in procs:
                p.terminate()
        time.sleep(0.2)
    for p in procs:
        p.join(timeout=10)
    results = []
    for r in range(len(procs)):
        path = os.path.join(root, f"rank{r}.pt")
        results.append(torch.load(path, weights_only=False)
                       if os.path.exists(path) else {"error": "no results"})
    errors = [r["error"] for r in results if "error" in r]
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"ranks failed (exit codes "
                           f"{[p.exitcode for p in procs]}):\n"
                           f"{errors[0] if errors else ''}")
    return results


def shared(tmp_path_factory, name, compute):
    """``compute(root)`` once a test run, for every pytest-xdist worker.

    A module fixture runs once a worker, and ``--dist load`` deals one
    file's tests to several workers; a fixture used by several files runs
    once a file besides.  Here the first worker to ask computes under a
    file lock in the run's temporary directory (the parent of each
    worker's own, which every worker of the run shares) and saves the
    result with ``torch.save``; the others wait on the lock and load it.
    Nothing is kept between runs.  A failure is saved too, so that the
    other workers raise it instead of computing again.  ``compute`` gets
    the shared directory ``root`` for its files; what it returns must
    pickle (arrays, tensors, state dicts, paths), so a fixture that hands
    out modules rebuilds them from the state dicts it loads."""
    import pathlib

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent          # the run's, shared by its workers
    root = pathlib.Path(base) / name
    root.mkdir(exist_ok=True)
    done, failed = root / "results.pt", root / "failed.txt"
    with open(root / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if failed.exists():
            raise RuntimeError(f"the shared fixture {name} failed in "
                               f"another worker:\n{failed.read_text()}")
        if not done.exists():
            try:
                result = compute(root)
            except Exception:
                failed.write_text(traceback.format_exc())
                raise
            torch.save(result, done)
    return torch.load(done, weights_only=False)
