"""The port's parallel layouts against the JAX package's mesh runs, on the
CPU (tests/test_parallel.py, case for case).

Four spawned ranks in a gloo group (``tests/torch_parallel_worker.py``,
one spawn a test session, on a ``file://`` store) run dp, tp, ZeRO-1 with
f32 and bf16 moments, the full Serenade step on data 2 x model 2 with
uneven lengths, the trainer's checkpoints of ZeRO-1 and tp states
restored onto their layout, onto another one and onto one process, and
``seq_sharded_attention``; then two of them run the train CLI with
``--data-axis 2 --zero1`` and with ``--model-axis 2`` and the distill CLI
with ``--data-axis 2``, whose checkpoints one-rank runs read.  While they
run, this process computes JAX's references on its 8-device CPU mesh
from the same numpy-seeded weights.  Batched inference over a data mesh
of CPU replicas (one controller, no group) runs here, and the tp and
ZeRO-1 rules are held against JAX's on Serenade's full-width tree, built
on the meta device and through ``jax.eval_shape``.  f32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import PartitionSpec as JP

from serenade_tpu.models import Serenade as JaxSerenade
from serenade_tpu.parallel import make_mesh as jax_make_mesh
from serenade_tpu.parallel import shard_batch as jax_shard_batch
from serenade_tpu.parallel import shard_params as jax_shard_params
from serenade_tpu.parallel import sharding as jax_sharding
from serenade_tpu.trainers import build_optimizer as jax_build_optimizer
from serenade_tpu.trainers import create_train_state as jax_create_state
from serenade_tpu.trainers.train_step import build_train_step as jax_bts

import torch_parallel_worker as worker
from serenade_tpu_torch import checkpoint as pckpt
from serenade_tpu_torch import configs
from serenade_tpu_torch.bin import compute_statistics as pstats
from serenade_tpu_torch.bin import ssc_decode as pdecode
from serenade_tpu_torch.bin import ssc_train as ptrain
from serenade_tpu_torch.convert import flax_paths, state_dict_from_flax
from serenade_tpu_torch.models.serenade import Serenade
from serenade_tpu_torch.parallel import make_mesh, sharding
from serenade_tpu_torch.parallel.mesh import replicate, run_replicas
from test_torch_train_cli import TRAIN, dump  # noqa: F401 (fixture)

WORLD = 4
CONFIG = {"optimizer_type": "AdamW", "optimizer_params": {"lr": 1e-2},
          "scheduler_type": "ConstantLR", "scheduler_params": {},
          "grad_norm": 1.0}
CONFIG_BF16 = dict(CONFIG, optimizer_params={"lr": 1e-2,
                                             "mu_dtype": "bfloat16"})
SGD = dict(CONFIG, optimizer_type="SGD", optimizer_params={"lr": 1e-2})
# JAX's full-model case, dropout 0 on both sides (torch cannot draw the
# TPU's dropout bits)
MODEL_CFG = dict(input_dim=32, output_dim=8, encoder_channels=8,
                 decoder_channels=256, gst_embed_dim=32,
                 decoder_attention_head_dim=64, dropout=0.0)
B, T = 4, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- JAX's references -------------------------------------------------------


class _JaxToy:
    def apply(self, params, x, *, rng, deterministic, rngs=None):
        w1, w2 = params["params"]["w1"], params["params"]["w2"]
        loss = jnp.mean(jnp.square(jnp.tanh(x @ w1) @ w2 - x))
        return {"cfm_loss": loss, "prior_loss": jnp.float32(0.0),
                "loss": loss}


def _toy_inputs():
    rng = np.random.default_rng(0)
    w1 = (rng.normal(size=(64, 1024)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(1024, 64)) * 0.1).astype(np.float32)
    x = rng.normal(size=(8, 16, 64)).astype(np.float32)
    return w1, w2, x


def _jax_toy(w1, w2, x, config, data, model_axis, steps=5, zero1=False):
    params = {"params": {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)}}
    tx, _ = jax_build_optimizer(config)
    mesh = jax_make_mesh(data=data, model=model_axis)
    params = jax_shard_params(params, mesh)
    state = jax_create_state(params, tx)
    shardings = None
    if zero1:
        shardings = jax_sharding.infer_opt_state_shardings(
            state.opt_state, mesh)
        state = state.__class__(
            params=state.params, step=state.step,
            opt_state=jax_sharding.shard_opt_state(state.opt_state, mesh))
    step = jax_bts(_JaxToy(), tx, batch_to_model_args=lambda b: ((b["x"],),
                                                                  {}),
                   donate=False, opt_state_shardings=shardings)
    xs = jax_shard_batch({"x": jnp.asarray(x)}, mesh)["x"]
    for i in range(steps):
        state, metrics = step(state, {"x": xs}, jax.random.key(i))
    p = jax.device_get(state.params)["params"]
    return float(metrics["train/loss"]), {k: np.asarray(v)
                                          for k, v in p.items()}


def _model_batch():
    ks = jax.random.split(jax.random.key(0), 5)
    return dict(
        x=np.asarray(jax.random.normal(ks[0], (B, T, 32))),
        lengths=np.asarray([T, T - 8, T, T // 2], np.int32),
        logmel=np.asarray(jax.random.normal(ks[1], (B, T, 8))),
        midi=np.asarray(jax.random.uniform(ks[2], (B, T, 1))),
        loud=np.asarray(jax.random.uniform(ks[3], (B, T, 1))))


def _draws(key):
    """JAX's segment, flow-time and noise draws for ``rng=key``
    (serenade.py:117-130, cfm.py:81-84), for the port's global batch."""
    k_seg, k_start, k_cfm = jax.random.split(key, 3)
    kt, kz = jax.random.split(k_cfm)
    return {"frac": np.asarray(jax.random.uniform(k_seg, (), minval=0.1,
                                                  maxval=0.5)),
            "start": np.asarray(jax.random.uniform(k_start, ())),
            "t": np.asarray(jax.random.uniform(kt, (B, 1, 1))).reshape(B),
            "z": np.asarray(jax.random.normal(kz, (B, T, 8)))}


def _jax_full_model(params, batch):
    jmodel = JaxSerenade(**MODEL_CFG, dtype=jnp.float32)
    tx, _ = jax_build_optimizer(SGD)
    mesh = jax_make_mesh(data=2, model=2)
    state = jax_create_state(jax_shard_params(
        jax.tree_util.tree_map(jnp.asarray, params), mesh), tx)
    step = jax_bts(jmodel, tx, donate=False)
    sb = jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                         mesh)
    losses = []
    for _ in range(2):
        state, metrics = step(state, sb, jax.random.key(7))
        losses.append(float(metrics["train/loss"]))
    return losses, jax.tree_util.tree_map(np.asarray,
                                          jax.device_get(state.params))


def _jax_model_params(batch):
    """Seeded random leaves of the JAX model's tree, shaped by
    ``jax.eval_shape`` of its init (nothing compiled): kernels N(0,
    1/fan-in), norm scales near 1, the rest small."""
    jmodel = JaxSerenade(**MODEL_CFG, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.key(1)}, b["x"], b["lengths"], b["logmel"],
        b["midi"], b["loud"], rng=jax.random.key(2), deterministic=True),
        {k: jnp.asarray(v) for k, v in batch.items()})
    rng = np.random.default_rng(1)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if name in ("scale", "g") else 0.0
        return (base + 0.05 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_attention(q, k, v, mask, heads):
    from serenade_tpu.ops.attention import multi_head_attention

    return np.asarray(multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=heads,
        key_mask=jnp.asarray(mask)))


# --- the spawn ----------------------------------------------------------------


def _cli_argv(root, dump_root, cfg_path, out, *extra):
    return ["--train-dumpdir", str(dump_root / "dump"), "--dev-dumpdir",
            str(dump_root / "dump"), "--stats", str(root / "stats.joblib"),
            "--outdir", str(root / out), "--config", str(cfg_path),
            "--device", "cpu", "--verbose", "0", *extra]


def _cli_inputs(root, dump_root):
    cfg = dict(TRAIN, num_workers=0)
    cfg_path = root / "train.yml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    pstats.main(["--rootdir", str(dump_root / "dump"), "--dumpdir",
                 str(root), "--config", str(cfg_path)])
    return {
        "dump_root": dump_root,
        "train_argvs": [
            _cli_argv(root, dump_root, cfg_path, "dp", "--data-axis", "2",
                      "--zero1"),
            _cli_argv(root, dump_root, cfg_path, "tp", "--model-axis", "2")],
        "distill_argv": [
            "--teacher-checkpoint", str(root / "dp" / "checkpoint-4steps"),
            "--config", str(root / "dp" / "config.yml"), "--train-dumpdir",
            str(dump_root / "dump"), "--stats", str(root / "stats.joblib"),
            "--outdir", str(root / "distilled"), "--distill-steps", "2",
            "--teacher-steps", "2", "--batch-size", "1", "--device", "cpu",
            "--verbose", "0", "--data-axis", "2"],
    }


def _shape_model():
    with torch.device("meta"):
        return Serenade(**MODEL_CFG, dtype="float32")


def _run(root, dump_root):
    w1, w2, x = _toy_inputs()
    batch = _model_batch()
    jparams = _jax_model_params(batch)
    model_sd = {k: v.numpy() for k, v in
                state_dict_from_flax(_shape_model(), jparams).items()}
    rng = np.random.default_rng(5)
    heads, hd = 4, 32
    att = {k: rng.normal(size=(2, 256, heads * hd)).astype(np.float32)
           for k in ("q", "k", "v")}
    att["mask"] = (np.arange(256)[None, :] < np.array(
        [[256], [206]])).astype(np.float32)
    cli = _cli_inputs(root, dump_root)
    inp = dict(w1=w1, w2=w2, x=x, config=CONFIG, config_bf16=CONFIG_BF16,
               sgd=SGD, model_cfg=MODEL_CFG, model_sd=model_sd, batch=batch,
               draws=_draws(jax.random.key(7)), heads=heads,
               ckpt_dir=str(root / "ckpt"), cli_store=str(root / "store2"),
               train_argvs=cli["train_argvs"],
               distill_argv=cli["distill_argv"], **att)
    procs = worker.spawn("parallel", WORLD, str(root), inp)
    # JAX's references while the ranks run
    ref = {"full": _jax_full_model(jparams, batch),
           "dp": _jax_toy(w1, w2, x, CONFIG, 4, 1),
           "tp": _jax_toy(w1, w2, x, CONFIG, 2, 2),
           "rep42": _jax_toy(w1, w2, x, CONFIG, 4, 2),
           "bf16": _jax_toy(w1, w2, x, CONFIG_BF16, 4, 1, steps=3,
                            zero1=True),
           "ckpt_tp": _jax_toy(w1, w2, x, CONFIG, 2, 2, steps=2),
           "attention": _jax_attention(att["q"], att["k"], att["v"],
                                       att["mask"], heads)}
    results = worker.collect(procs, str(root))
    return dict(root=root, ref=ref, ranks=results, cli=cli,
                jparams=jparams)


@pytest.fixture(scope="module")
def run(tmp_path_factory, request):
    """The ranks' results and JAX's references, once a session."""
    return worker.shared(tmp_path_factory, "torch_parallel", lambda root: _run(
        root, request.getfixturevalue("dump")))


def _toy(run, rank=0):
    return run["ranks"][rank]["scenario_toy"]


def _close_params(got, want, atol):
    # the port's Dense weights are (out, in): JAX's kernels transposed
    for k, name in (("w1.weight", "w1"), ("w2.weight", "w2")):
        np.testing.assert_allclose(got[k], want[name].T, atol=atol,
                                   err_msg=k)


def test_dp_matches_single_device(run):
    got, (loss, params) = _toy(run)["dp"], run["ref"]["dp"]
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    _close_params(got["params"], params, 5e-4)


def test_tp_matches_single_device(run):
    got, (loss, params) = _toy(run)["tp"], run["ref"]["tp"]
    # w1 (64, 1024) in flax: 65536 elements, split on its output features,
    # the port's dimension 0; each rank keeps half
    assert got["tp"] == {"w1.weight": (0, 1)}
    assert got["local"]["w1.weight"] == (512, 64)
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    _close_params(got["params"], params, 5e-4)


def test_zero1_matches_replicated_opt_state(run):
    """ZeRO-1 moves where the Adam math runs, not its result; the moments
    of w1 keep tp's split and add data's, and each rank holds half of
    every split moment."""
    got, (loss, params) = _toy(run)["zero1"], run["ref"]["rep42"]
    assert got["z1"] == {"w1.weight": (1, 1), "w2.weight": (1, 1)}
    for name, (local, full, _) in got["moments"].items():
        share = 4 if name == "w1.weight" else 2   # tp x data, or data
        assert local * share == full, (name, local, full)
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    _close_params(got["params"], params, 5e-4)


def test_mu_dtype_bf16_moments(run):
    """bf16 first moments under ZeRO-1 on data 4: the moments are bf16 and
    a quarter on each rank.  The run follows the port's one-process
    bf16-moment run: a gradient that differs at f32 rounding (the ranks
    sum in another order) can flip an element's bf16 rounding and move
    its update by 2^-8, so parameters within 3 updates x lr x 2^-8 =
    1.2e-4; and JAX's within JAX's own bf16 tolerance (2e-3 on the
    parameters; the two round the bf16 moment at different points, 1e-4
    of the loss after 3 steps)."""
    from serenade_tpu_torch.trainers import (
        build_optimizer, build_train_step, create_train_state,
    )

    got, (loss, params) = _toy(run)["bf16"], run["ref"]["bf16"]
    for name, (local, full, dtype) in got["moments"].items():
        assert dtype == "torch.bfloat16" and local * 4 == full, name
    w1, w2, x = _toy_inputs()
    model = worker.Toy(w1, w2)
    opt, _ = build_optimizer(CONFIG_BF16)
    state = create_train_state(model, opt)
    step = build_train_step(model, opt, device="cpu")
    for _ in range(3):
        state, metrics = step(state, worker._toy_batch(x))
    assert got["loss"] == pytest.approx(float(metrics["train/loss"]),
                                        rel=1e-5)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got["params"][k], v.numpy(),
                                   atol=1.2e-4, err_msg=k)
    assert got["loss"] == pytest.approx(loss, rel=1e-4)
    _close_params(got["params"], params, 2e-3)


def test_full_model_step_tp_matches_replicated(run):
    """The full Serenade step on data 2 x model 2 with uneven lengths
    against JAX's on its mesh: the losses (global masked means, the
    segment from the global longest length) and every parameter; the
    leaves tp splits are the ones JAX's rule splits."""
    got = run["ranks"][0]["scenario_full_model"]
    losses, jparams = run["ref"]["full"]
    assert len(got["tp"]) >= 4
    specs = jax_sharding.infer_param_shardings(
        run["jparams"], jax_make_mesh(data=2, model=2))
    picked = {"/".join(str(getattr(k, "key", k)) for k in path)
              for path, s in jax.tree_util.tree_leaves_with_path(
                  specs, is_leaf=lambda s: hasattr(s, "spec"))
              if "model" in str(s.spec)}
    paths = flax_paths(_shape_model())
    assert {p for n in got["tp"] for p in paths[n]} == picked
    for g, w in zip(got["losses"], losses):
        assert g == pytest.approx(w, rel=1e-5)
    want = state_dict_from_flax(_shape_model(), jparams)
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, want[k].numpy(), atol=1e-5,
                                   err_msg=k)


def test_zero1_checkpoint_roundtrip(run):
    got = run["ranks"][1]["scenario_checkpoints"]
    assert got["zero1_equal"] and got["zero1_step"] == 2
    # restored onto the ZeRO-1 placement, not gathered
    assert got["zero1_shapes"] == {"w1.weight": (512, 32),
                                   "w2.weight": (64, 512)}
    # the file holds the one-card layout, which one process reads
    full = pckpt.restore_checkpoint(str(run["root"] / "ckpt" / "zero1"
                                        / "checkpoint-2steps"))
    assert full["opt_state"]["mu"]["w1.weight"].shape == (1024, 64)


def test_sharded_checkpoint_roundtrip_and_reshard(run):
    """A tp state's checkpoint restores bit for bit onto data 4 x model 1,
    which steps on, and onto one process."""
    for rank in range(WORLD):
        got = run["ranks"][rank]["scenario_checkpoints"]
        assert got["reshard_equal"] and got["reshard_step"] == 2
        assert np.isfinite(got["reshard_loss"])
    params = pckpt.restore_params_only(str(
        run["root"] / "ckpt" / "tp" / "checkpoint-2steps"))
    _close_params({k: v.numpy() for k, v in params.items()},
                  run["ref"]["ckpt_tp"][1], 5e-4)


def test_seq_sharded_attention_matches_single_device(run):
    for rank in range(WORLD):
        got = run["ranks"][rank]["scenario_seq_attention"]["out"]
        np.testing.assert_allclose(got, run["ref"]["attention"], atol=1e-5,
                                   rtol=1e-5)


# --- the CLIs -----------------------------------------------------------------


def _last_params(outdir):
    return pckpt.restore_params_only(pckpt.find_latest_checkpoint(outdir))


@pytest.mark.parametrize("layout", ["dp_zero1", "tp"])
def test_train_cli_layout_matches_one_rank_run(run, layout):
    """The 2-rank CLI run's checkpoint (the one-card layout, written by
    rank 0) against a one-rank run of the same global batch: ``--data-axis
    2 --zero1`` reads batches of 4 and splits them, ``--model-axis 2``
    reads batches of 2 on both ranks."""
    root, cli = run["root"], run["cli"]
    name, batch = ("dp", 4) if layout == "dp_zero1" else ("tp", 2)
    one = f"one_{name}"
    cfg = root / f"{one}.yml"
    cfg.write_text(yaml.safe_dump(dict(TRAIN, num_workers=0,
                                       batch_size=batch)))
    ptrain.main(_cli_argv(root, cli["dump_root"], cfg, one))
    got, want = _last_params(str(root / name)), _last_params(str(root / one))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=5e-5, err_msg=k)
    ckpt = pckpt.restore_checkpoint(pckpt.find_latest_checkpoint(
        str(root / name)))
    assert ckpt["meta"]["step"] == 4
    assert (root / name / "predictions" / "4steps").is_dir()


def test_distill_and_decode_cli_data_axis(run):
    """The 2-rank distillation's checkpoint decodes in one process, with
    ``--data-axis 2`` (two CPU replicas of the converter)."""
    root = run["root"]
    ckpt = pckpt.find_latest_checkpoint(str(root / "distilled"))
    assert ckpt.endswith("checkpoint-2steps")
    out = root / "decoded"
    pdecode.main(["--dumpdir", run["cli"]["train_argvs"][0][1], "--stats",
                  str(root / "stats.joblib"), "--outdir", str(out),
                  "--checkpoint", ckpt, "--device", "cpu", "--batch-size",
                  "3", "--data-axis", "2", "--verbose", "0"])
    mels = [f for f in os.listdir(out) if f.endswith(".h5")
            and not f.startswith("00_")]
    assert mels


def test_batched_inference_dp_sharded_matches_replicated():
    """Data-parallel inference on one controller: batch 8 over 8 CPU
    replicas, each converting its row, against JAX's batch sharded over
    its 8 devices."""
    cfg = dict(input_dim=32, output_dim=8, encoder_channels=8,
               decoder_channels=64, gst_embed_dim=32,
               decoder_attention_head_dim=32)
    jmodel = JaxSerenade(**cfg, dtype=jnp.float32)
    b, ts, tr = 8, 64, 32
    ks = jax.random.split(jax.random.key(5), 9)
    args = (jax.random.normal(ks[0], (b, ts, 32)),
            jnp.array([ts - (i % 3) * 8 for i in range(b)]),
            jax.random.uniform(ks[1], (b, ts, 1)),
            jax.random.uniform(ks[2], (b, ts, 1)),
            jax.random.normal(ks[3], (b, tr, 32)),
            jnp.array([tr - (i % 2) * 8 for i in range(b)]),
            jax.random.normal(ks[4], (b, tr, 8)),
            jax.random.uniform(ks[5], (b, tr, 1)),
            jax.random.uniform(ks[6], (b, tr, 1)))
    params = jax.jit(lambda *a: jmodel.init(
        {"params": ks[7]}, a[0], a[1], jax.random.normal(ks[8], (b, ts, 8)),
        a[2], a[3], rng=jax.random.key(0), deterministic=True))(*args)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("data",))
    sharded = tuple(jax.device_put(a, jax.sharding.NamedSharding(
        mesh, JP(*(("data",) + (None,) * (a.ndim - 1))))) for a in args)
    want = np.asarray(jax.jit(lambda p, *a: jmodel.apply(
        p, *a, rng=jax.random.key(1), n_timesteps=2,
        method="inference"))(params, *sharded))
    x0 = np.array(jax.random.normal(jax.random.key(1), (b, ts + tr, 8))
                  * 0.667)

    model = Serenade(**cfg, dtype="float32")
    model.load_state_dict(state_dict_from_flax(
        model, jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    pmesh = make_mesh(data=8, devices=["cpu"] * 8)
    replicas = replicate(model, pmesh)
    assert all(r is model for r in replicas)   # one device: shared weights
    rows = [torch.from_numpy(np.array(a)) for a in args] + [
        torch.from_numpy(x0)]

    def one(i, _):
        mine = [r[i:i + 1] for r in rows]
        return replicas[i].inference(*mine[:-1], x0=mine[-1], n_timesteps=2)

    got = torch.cat(run_replicas(pmesh, one, range(8))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


# --- the rules on Serenade's full-width tree ---------------------------------


@pytest.fixture(scope="module")
def full_width():
    """The full-width flax tree's shapes (``jax.eval_shape``) and the port
    model on the meta device: nothing is compiled or allocated."""
    cfg = configs.serenade_config()
    jmodel = JaxSerenade(**{k: v for k, v in cfg.items() if k != "dtype"})
    b, t = 2, 64
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0)}, jnp.zeros((b, t, 768)),
        jnp.full((b,), t), jnp.zeros((b, t, 80)), jnp.zeros((b, t, 1)),
        jnp.zeros((b, t, 1)), rng=jax.random.key(1), deterministic=True))
    with torch.device("meta"):
        model = Serenade(**cfg)
    return shapes, model


def _jax_specs(shapes, rule):
    return {"/".join(str(getattr(k, "key", k)) for k in path): rule(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}


def _port_specs(model, specs):
    paths = flax_paths(model)
    return {p: specs[n] for n in specs for p in paths[n]}


@pytest.mark.parametrize("model_size", [2, 4, 8])
def test_tp_rule_picks_jax_leaves_at_full_width(full_width, model_size):
    shapes, model = full_width
    want = _jax_specs(shapes, lambda leaf: jax_sharding._leaf_spec(
        leaf, model_size))
    got = _port_specs(model, {n: sharding._leaf_spec(leaf.shape, model_size)
                              for n, leaf in sharding.flax_leaf_shapes(
                                  model).items()})
    assert set(got) == set(want)
    assert {p: tuple(s) for p, s in got.items()} == {
        p: tuple(s) for p, s in want.items()}
    assert sum("model" in s for s in got.values()) > 0


@pytest.mark.parametrize("data_size,model_size", [(2, 1), (4, 2), (8, 1),
                                                  (2, 4)])
def test_zero1_rule_picks_jax_axes_at_full_width(full_width, data_size,
                                                 model_size):
    shapes, model = full_width
    want = _jax_specs(shapes, lambda leaf: jax_sharding._zero1_spec(
        leaf, data_size, model_size))
    got = _port_specs(model, {
        n: sharding._zero1_spec(leaf.shape, data_size, model_size)
        for n, leaf in sharding.flax_leaf_shapes(model).items()})
    assert {p: tuple(s) for p, s in got.items()} == {
        p: tuple(s) for p, s in want.items()}
    assert sum("data" in s for s in got.values()) > 0


def test_converter_data_mesh_and_vocoder_tail():
    """``Converter(data_mesh=2)`` on the CPU: a batch of 3 pads to 4, each
    replica converts 2 rows, and the mels equal the one-replica batch's
    from the same noise; the server's batching places the vocoder on the
    mesh, whose tail equals the one-replica tail."""
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.serving import BatchingConverter

    cfg = dict(input_dim=32, output_dim=80, encoder_channels=16,
               encoder_hidden_dim=32, decoder_channels=64, gst_embed_dim=32,
               decoder_attention_head_dim=32, gst_tokens=10,
               gst_conv_chans=(8, 8, 16, 16), gst_gru_units=16,
               dtype="float32")
    voc = {"sampling_rate": 24000, "generator_params": {
        "channels": 32, "upsample_scales": [4, 3],
        "upsample_kernel_sizes": [8, 6]}}
    scaler = {"hubert": {"mean": np.zeros(32), "scale": np.ones(32)},
              "score": {"min": 0.0, "max": 1.0},
              "loud": {"min": 0.0, "max": 1.0},
              "logmel": {"mean": np.zeros(80), "scale": np.ones(80)}}
    rng = np.random.default_rng(3)

    def feats(t, mel):
        f = {"hubert": rng.normal(size=(t, 32)), "score": rng.random(t),
             "loud": rng.random(t)}
        if mel:
            f["logmel"] = rng.normal(size=(t, 80))
        return f

    src = [feats(t, False) for t in (60, 50, 64)]
    ref = [feats(t, True) for t in (40, 64, 30)]
    x0 = rng.normal(size=(4, 64 + 64, 80)) * 0.667
    out = {}
    for n in (None, 2):
        conv = Converter(cfg, None, scaler, vocoder_config=voc,
                         vocoder_stats={"mean": np.zeros(80),
                                        "scale": np.ones(80)},
                         n_timesteps=2, seed=1, device="cpu", data_mesh=n)
        mels, lens = conv.convert_features_batch(
            src, ref, x0=x0 if n else x0[:3], return_device=True)
        if n:
            assert conv.mesh.shape == {"data": 2, "model": 1}
            assert mels.shape[0] == 4
            server = BatchingConverter(conv)
            assert conv.vocoder.mesh is conv.mesh
            server.close()
            mels = mels[:3]
        if n:   # the mesh's tail takes a multiple of its replicas
            mels, lens = torch.cat([mels, mels[-1:]]), lens + [lens[-1]]
        wav = conv.vocoder.decode_batch_device(mels, lens)
        out[n] = mels[:3].numpy(), wav[:3].numpy()
    np.testing.assert_allclose(out[2][0], out[None][0], atol=1e-5)
    assert np.abs(out[2][1].astype(np.int32)
                  - out[None][1].astype(np.int32)).max() <= 1
