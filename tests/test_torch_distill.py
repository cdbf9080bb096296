"""Few-step distillation of the port against the JAX package, on the CPU.

``Serenade.make_reflow_batch`` (and the variant's) and
``distill_config_overrides`` against ``serenade_tpu``'s, with the same
parameters (random leaves of the shapes JAX's ``init`` gives,
``jax.eval_shape``, through the param bridge), the same numpy inputs and
JAX's own draws handed to the port; ``CFM.rollout``; then
``bin/distill.py`` on a tiny dump, read back by the port's
``ssc_decode``, and what the CLI refuses.  The steps of
``trainers/distill.py`` are held in ``test_torch_distill_steps.py`` (a
file of their own, so that the two JAX traces run beside these).  The
widths of JAX's own contract test (``tests/test_distill.py``: input 12,
output 8, decoder channels 16, B 2 x T 32, teacher 3 steps), f32 unless
stated, dropout 0 on both sides (torch cannot draw the TPU's dropout
bits).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from serenade_tpu.models.serenade import Serenade as JaxSerenade
from serenade_tpu.models.serenade_new import SerenadeNew as JaxSerenadeNew
from serenade_tpu.trainers import distill as jdistill
from serenade_tpu.utils import h5 as jh5

from serenade_tpu_torch import checkpoint as pckpt
from serenade_tpu_torch.bin import compute_statistics as pstats
from serenade_tpu_torch.bin import distill as pdistill
from serenade_tpu_torch.bin import ssc_decode as pdecode
from serenade_tpu_torch.convert import load_params
from serenade_tpu_torch.models.cfm import CFM
from serenade_tpu_torch.models.layers import init_params_
from serenade_tpu_torch.models.serenade import Serenade
from serenade_tpu_torch.models.serenade_new import SerenadeNew
from serenade_tpu_torch.trainers.distill import distill_config_overrides
from test_torch_models import assert_bf16_parity

CFG = dict(input_dim=12, output_dim=8, encoder_channels=8,
           decoder_channels=16, gst_embed_dim=16,
           decoder_attention_head_dim=16, gst_tokens=10,
           gst_conv_chans=(8, 8, 16, 16), gst_gru_units=8, dropout=0.0)
B, T, LENGTHS, TEMP, TEACHER_STEPS = 2, 32, (32, 24), 0.667, 3
ARGS = ("x", "lengths", "logmel", "midi", "loud")
MODELS = {"Serenade": (JaxSerenade, Serenade),
          "SerenadeNew": (JaxSerenadeNew, SerenadeNew)}
OPT = {"optimizer_type": "AdamW",
       "optimizer_params": {"lr": 1e-3, "eps": 1e-3}, "grad_norm": 1.0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU ops beside JAX's thread pools: torch's intra-op threads
    only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _batch(rng, with_fluc=False):
    batch = {"x": rng.normal(size=(B, T, 12)).astype(np.float32),
             "lengths": np.asarray(LENGTHS, np.int32),
             "logmel": rng.normal(size=(B, T, 8)).astype(np.float32),
             "midi": rng.uniform(size=(B, T, 1)).astype(np.float32),
             "loud": rng.uniform(size=(B, T, 1)).astype(np.float32)}
    if with_fluc:
        batch["f0_fluc"] = (0.1 * rng.normal(size=(B, T, 1))).astype(
            np.float32)
    return batch


@pytest.fixture(scope="module")
def jax_models():
    """name -> (JAX model, random parameters of its shapes), f32."""
    out = {}
    key = jax.random.key(0)
    for i, (name, (jcls, _)) in enumerate(MODELS.items()):
        jmodel = jcls(**CFG, dtype=jnp.float32)
        batch = _batch(np.random.default_rng(0), name == "SerenadeNew")
        args = [jnp.asarray(batch[k]) for k in ARGS]
        if name == "SerenadeNew":
            args.append(jnp.asarray(batch["f0_fluc"]))
        shapes = jax.eval_shape(lambda *a: jmodel.init(key, *a, rng=key),
                                *args)
        out[name] = (jmodel, _seeded_tree(shapes, 1 + i))
    return out


def _seeded_tree(shapes, seed):
    """Random leaves of ``init``'s shapes: matrices N(0, 1/fan_in), scales
    1 + N(0, 0.05^2), other vectors N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if str(path[-1].key) in ("scale", "g") else 0.0
        return (base + 0.05 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _port(name, params, dtype="float32"):
    return load_params(MODELS[name][1](**CFG, dtype=dtype), params)


def _pair_draws(key, mask_size=(0.1, 1.0)):
    """JAX's draws for ``make_reflow_batch(rng=key)``
    (serenade.py:198-228): the segment fraction and start, and x0."""
    k_seg, k_start, k_x0 = jax.random.split(key, 3)
    return {"frac": _t(jax.random.uniform(k_seg, (), minval=mask_size[0],
                                          maxval=mask_size[1])),
            "start": _t(jax.random.uniform(k_start, ())),
            "x0": _t(TEMP * jax.random.normal(k_x0, (B, T, 8),
                                              jnp.float32))}


def _step_draws(key):
    """JAX's draws for one ``build_distill_step`` step with ``rng=key``
    (distill.py:117-125, cfm.py:81-82): the pair's, and the reflow
    loss's flow times."""
    k_pair, k_loss = jax.random.split(key)
    kt, _ = jax.random.split(k_loss)
    draws = _pair_draws(k_pair)
    draws["t"] = _t(jax.random.uniform(kt, (B, 1, 1), jnp.float32)
                    ).reshape(B)
    return draws


_JAX_PAIRS = {}


def _jax_pair(jmodel, params, batch, key, extras=None):
    """JAX's ``make_reflow_batch``, one jitted program a model (the key
    and extras are arguments, so tests share its trace)."""
    fn = _JAX_PAIRS.get(jmodel)
    if fn is None:
        fn = _JAX_PAIRS[jmodel] = jax.jit(
            lambda p, k, ex, *a: jmodel.apply(
                p, *a, rng=k, n_timesteps=TEACHER_STEPS, temperature=TEMP,
                method="make_reflow_batch", extras=ex))
    return jax.tree_util.tree_map(np.asarray, fn(
        params, key, extras, *(jnp.asarray(batch[k]) for k in ARGS)))


def _port_pair(model, batch, draws, extras=None):
    return model.make_reflow_batch(
        *(torch.as_tensor(batch[k]) for k in ARGS), draws=draws,
        n_timesteps=TEACHER_STEPS, temperature=TEMP, extras=extras)


@pytest.mark.parametrize("name", list(MODELS))
def test_make_reflow_batch_matches_jax(jax_models, name):
    """The pair against JAX's from the same draws: mask exactly, x0
    within an ulp (JAX's program draws it fused with the scale; the
    test's draw is eager), mu (the encoder's output among it) and spk
    within 1e-5, the teacher's endpoint after 3 Euler steps within 1e-4.
    The variant rolls ``f0_fluc`` as training does (``draws["s1"]``,
    ``["s2"]``): JAX's method gets the rolled pair itself, since the
    unrolled track its CLI hands over stops JAX on the shape (ROADMAP
    Queue C)."""
    jmodel, params = jax_models[name]
    batch = _batch(np.random.default_rng(2), name == "SerenadeNew")
    key = jax.random.key(7)
    draws, extras, jextras = _pair_draws(key), None, None
    if name == "SerenadeNew":
        draws.update(s1=torch.tensor(5), s2=torch.tensor(29))
        fluc = batch["f0_fluc"]
        extras = {"fluc": torch.as_tensor(fluc)}
        jextras = {"fluc": jnp.concatenate(
            [jnp.roll(fluc, 5, axis=1), jnp.roll(fluc, 29, axis=1)], -1)}
    want = _jax_pair(jmodel, params, batch, key, jextras)
    got = _port_pair(_port(name, params), batch, draws, extras)
    assert not got["x1_hat"].requires_grad
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    np.testing.assert_allclose(got["x0"].numpy(), want["x0"], rtol=1e-6,
                               atol=0)
    for k in ("mu", "spk"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["x1_hat"].numpy(), want["x1_hat"],
                               rtol=1e-4, atol=1e-4)
    # the segment reaches past the training range's 0.5 (frac ~ U(0.1, 1))
    assert 0.1 <= float(draws["frac"]) < 1.0


def test_make_reflow_batch_bf16_matches_jax(jax_models):
    """bf16 compute, f32 parameters: the teacher's endpoint on valid
    frames held against JAX's by ``assert_bf16_parity``."""
    jmodel, params = jax_models["Serenade"]
    # the f32 case's batch and key: its JAX result is traced once
    batch = _batch(np.random.default_rng(2))
    key = jax.random.key(7)
    want32 = _jax_pair(jmodel, params, batch, key)["x1_hat"]
    jbf16 = JaxSerenade(**CFG, dtype=jnp.bfloat16)
    want16 = _jax_pair(jbf16, params, batch, key)["x1_hat"]
    got = _port_pair(_port("Serenade", params, "bfloat16"), batch,
                     _pair_draws(key))["x1_hat"]
    valid = np.arange(T)[None, :] < np.asarray(LENGTHS)[:, None]
    assert_bf16_parity(got.float().numpy()[valid],
                       np.asarray(want16, np.float32)[valid], want32[valid])


def test_rollout_is_inference_with_autograd():
    """``CFM.inference`` is ``rollout`` under no_grad: the same mel from
    the same x0, no graph; ``rollout`` under grad gives gradients."""
    cfm = init_params_(CFM(in_channels=18, out_channels=8, spk_embed_dim=16,
                           decoder_channels=(16, 16),
                           decoder_attention_head_dim=16, dropout=0.0), 2)
    rng = np.random.default_rng(6)
    mu, spk = _t(rng.normal(size=(B, T, 10))), _t(rng.normal(size=(B, 16)))
    mask = (torch.arange(T)[None, :, None]
            < torch.tensor(LENGTHS)[:, None, None]).float()
    x0 = _t(rng.normal(size=(B, T, 8)))
    for solver in ("euler", "midpoint", "ab2"):
        ref = cfm.inference(mu, mask, spk, n_timesteps=3, solver=solver,
                            x0=x0)
        assert not ref.requires_grad
        got = cfm.rollout(mu, mask, spk, x0, n_timesteps=3, solver=solver)
        assert got.requires_grad
        torch.testing.assert_close(got.detach(), ref, rtol=0, atol=0)
    got.square().sum().backward()
    assert all(p.grad is not None for p in cfm.estimator.parameters())


def test_distill_config_overrides_match_jax():
    for config in ({"batch_size": 4}, {"inference_n_timesteps": 1,
                                       "inference_solver": "ab2"}):
        assert distill_config_overrides(config) == \
            jdistill.distill_config_overrides(config)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

MODEL_PARAMS = dict(CFG, dtype="float32")
UTTS = (("EN_s1_song0_Breathy_Group_0", 60), ("EN_s1_song1_Falsetto_Group_0",
                                              45),
        ("EN_s1_song2_Breathy_Group_0", 52), ("EN_s1_song3_Falsetto_Group_0",
                                              40))
TEACHER_CONFIG = {
    "sampling_rate": 24000, "batch_size": 2, "score_type": "est_lf0_score",
    "optimizer_type": "AdamW",
    "optimizer_params": {"lr": 8e-4, "mu_dtype": "bfloat16"},
    "grad_norm": 1.0, "scheduler_type": "MultiStepLR",
    "scheduler_params": {"gamma": 0.5, "milestones": [100]},
    "log_interval_steps": 100}
TYPES = {"Serenade": ("SSCTrainer", "SSCCollater", "FeatsDataset"),
         "SerenadeNew": ("SSCTrainerNew", "SSCCollaterNew",
                         "FeatsDatasetNew")}


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """Four utterances of two styles (``f0_fluc`` too) and their
    statistics."""
    root = tmp_path_factory.mktemp("distill")
    rng = np.random.default_rng(0)
    for utt, t in UTTS:
        h5 = str(root / "dump" / f"{utt}.h5")
        jh5.write_hdf5(h5, "wave", (rng.normal(size=t * 240) * 0.1).astype(
            np.float32))
        jh5.write_hdf5(h5, "hubert", rng.normal(size=(t, 12)).astype(
            np.float32) * 2 + 1)
        jh5.write_hdf5(h5, "logmel",
                       rng.normal(size=(t, 8)).astype(np.float32) - 3)
        jh5.write_hdf5(h5, "loud", rng.uniform(-60, 0, (t, 1)).astype(
            np.float32))
        jh5.write_hdf5(h5, "est_lf0_score", rng.uniform(
            40, 80, (t, 1)).astype(np.float32))
        jh5.write_hdf5(h5, "midi", rng.uniform(40, 80, t).astype(np.float32))
        jh5.write_hdf5(h5, "f0_fluc", (0.1 * rng.normal(size=(t, 1))).astype(
            np.float32))
        jh5.write_hdf5(h5, "f0", rng.uniform(150, 300, (t, 1)).astype(
            np.float32))
    cfg = root / "stats.yml"
    cfg.write_text(yaml.safe_dump(TEACHER_CONFIG))
    pstats.main(["--rootdir", str(root / "dump"), "--dumpdir", str(root),
                 "--config", str(cfg)])
    return root


def _teacher_dir(root, model_type):
    """A port checkpoint of seeded weights beside its config.yml."""
    trainer, collater, dataset = TYPES[model_type]
    exp = root / f"teacher_{model_type}"
    exp.mkdir()
    config = dict(TEACHER_CONFIG, model_type=model_type,
                  model_params=MODEL_PARAMS, trainer_type=trainer,
                  collater_type=collater, dataset_type=dataset)
    (exp / "config.yml").write_text(yaml.safe_dump(config))
    model = init_params_(MODELS[model_type][1](**MODEL_PARAMS), seed=3)
    return exp, pckpt.save_checkpoint(str(exp), 40, model.state_dict())


def _distill_argv(dump, exp, ckpt, outdir, *extra):
    return ["--teacher-checkpoint", ckpt, "--config",
            str(exp / "config.yml"), "--train-dumpdir", str(dump / "dump"),
            "--stats", str(dump / "stats.joblib"), "--outdir", str(outdir),
            "--device", "cpu", *extra]


@pytest.mark.parametrize("model_type", list(TYPES))
def test_distill_cli_then_decode_samples_the_student_steps(
        dump, tmp_path, monkeypatch, model_type):
    """2 reflow steps of the CLI (teacher Euler-2, batch 2) write the
    distilled config and checkpoints at 1 and 2 steps with a frozen
    encoder and GST; the port's decode reads that checkpoint and its
    config and samples with 2 Euler steps (the default, as no flag names
    one)."""
    exp, ckpt = _teacher_dir(tmp_path, model_type)
    out = tmp_path / "distilled"
    pdistill.main(_distill_argv(dump, exp, ckpt, out, "--distill-steps", "2",
                                "--teacher-steps", "2", "--mode", "reflow",
                                "--lr", "1e-3"))
    config = yaml.safe_load((out / "config.yml").read_text())
    assert config["distilled"] is True
    assert config["model_type"] == model_type
    assert (config["inference_n_timesteps"], config["inference_solver"],
            config["distill_mode"], config["scheduler_type"]) == \
        (2, "euler", "reflow", "ConstantLR")
    assert config["optimizer_params"] == {"lr": 1e-3, "mu_dtype": "bfloat16"}
    assert sorted(n for n in os.listdir(out) if n.startswith("checkpoint")) \
        == ["checkpoint-1steps", "checkpoint-2steps"]
    teacher = pckpt.restore_params_only(ckpt)
    student = pckpt.restore_params_only(str(out / "checkpoint-2steps"))
    assert set(student) == set(teacher)
    for k, v in student.items():
        if k.startswith(("encoder.", "gst.")):
            assert torch.equal(v, teacher[k]), k
    assert any(not torch.equal(v, teacher[k]) for k, v in student.items()
               if k.startswith("cfm_decoder."))

    steps = []
    rollout = CFM.rollout

    def spy(self, *a, n_timesteps=10, **kw):
        steps.append(n_timesteps)
        return rollout(self, *a, n_timesteps=n_timesteps, **kw)

    monkeypatch.setattr(CFM, "rollout", spy)
    decoded = tmp_path / "decoded"
    pdecode.main(["--dumpdir", str(dump / "dump"), "--stats",
                  str(dump / "stats.joblib"), "--outdir", str(decoded),
                  "--checkpoint", str(out / "checkpoint-2steps"),
                  "--batch-size", "2", "--device", "cpu"])
    assert steps and set(steps) == {2}
    mels = [f for f in os.listdir(decoded) if f.endswith(".h5")
            and not f.startswith("00_")]
    assert len(mels) >= len(UTTS)
    for name in mels:
        assert np.isfinite(jh5.read_hdf5(str(decoded / name), "mel")).all()


@pytest.mark.parametrize("case", ["data_axis", "orbax"])
def test_distill_cli_refuses_by_name(dump, tmp_path, case):
    exp, ckpt = _teacher_dir(tmp_path, "Serenade")
    if case == "data_axis":
        # a world of one process: the 2-rank run is in test_torch_parallel
        with pytest.raises(SystemExit, match="--data-axis 2 .*torchrun"):
            pdistill.main(_distill_argv(dump, exp, ckpt, tmp_path / "o",
                                        "--data-axis", "2"))
        return
    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="Orbax"):
        pdistill.main(_distill_argv(dump, exp, str(orbax), tmp_path / "o"))
