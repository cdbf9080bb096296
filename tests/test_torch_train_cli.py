"""The port's training CLIs and the training options around the loop, on
the CPU.

``bin/compute_statistics.py`` against the JAX package's on one tiny dump
(the same ``stats.joblib`` arrays through both readers); the freeze and
transfer masks of ``utils/model_io.py`` for JAX's flax path prefixes and
the masked optimizer against ``optax.multi_transform``; the chain
statistics → ``bin/ssc_train.py`` → ``--resume latest`` → the port's
``bin/ssc_decode.py`` (as ``tests/test_e2e_pipeline.py`` runs JAX's),
``--init-checkpoint`` from a port checkpoint with ``load_mods`` and
``freeze_mods`` and from a reference torch ``.pkl``; ``remat``; the
parameter table at full width; and what the train CLI refuses by name.
Small widths, f32.
"""

import os

import jax
import jax.numpy as jnp
import joblib
import numpy as np
import optax
import pytest
import torch
import yaml

from serenade_tpu.trainers import build_optimizer as jax_build_optimizer
from serenade_tpu.utils import h5 as jh5
from serenade_tpu.utils import model_io as jio

from serenade_tpu_torch import checkpoint as pckpt
from serenade_tpu_torch import configs
from serenade_tpu_torch.bin import compute_statistics as pstats
from serenade_tpu_torch.bin import ssc_decode as pdecode
from serenade_tpu_torch.bin import ssc_train as ptrain
from serenade_tpu_torch.convert import flax_paths, state_dict_from_flax
from serenade_tpu_torch.models.convert_serenade import convert_serenade
from serenade_tpu_torch.models.layers import init_params_
from serenade_tpu_torch.models.serenade import Serenade
from serenade_tpu_torch.trainers import build_optimizer
from serenade_tpu_torch.utils import model_io
from serenade_tpu_torch.utils.scalers import load_scalers
from test_torch_train import CFG, _np
from test_torch_train_loop import _port, jax_model  # noqa: F401 (fixture)
import torch_parallel_worker as worker
from tests.test_serenade_convert import (
    DEC_CH, ENC_CH, GRU_UNITS, GST_CHANS, GST_DIM, HEAD_DIM, IN_DIM, MEL,
    _build_torch_twin,
)

# the reference twin's widths (tests/test_serenade_convert.py), so a
# reference .pkl of it can start a run
MODEL_PARAMS = dict(
    input_dim=IN_DIM, output_dim=MEL, encoder_channels=ENC_CH,
    encoder_hidden_dim=24, gst_tokens=10, gst_conv_chans=list(GST_CHANS),
    gst_gru_units=GRU_UNITS, decoder_channels=DEC_CH, gst_embed_dim=GST_DIM,
    decoder_attention_head_dim=HEAD_DIM, dropout=0.0, dtype="float32")
# six utterances of two singers' styles, so the decode finds references
UTTS = (("EN_s1_song0_Breathy_Group_0", 120),
        ("EN_s1_song1_Falsetto_Group_0", 90),
        ("EN_s1_song2_Breathy_Group_0", 130),
        ("EN_s1_song3_Falsetto_Group_0", 70),
        ("EN_s1_song4_Mixed_Voice_Group_0", 100),
        ("EN_s1_song5_Breathy_Group_0", 60))
TRAIN = {"sampling_rate": 24000, "model_type": "Serenade",
         "model_params": MODEL_PARAMS, "trainer_type": "SSCTrainer",
         "collater_type": "SSCCollater", "dataset_type": "FeatsDataset",
         "score_type": "est_lf0_score", "batch_size": 2,
         "optimizer_type": "AdamW",
         "optimizer_params": {"lr": 1e-3, "mu_dtype": "bfloat16"},
         "grad_norm": 1.0, "scheduler_type": "MultiStepLR",
         "scheduler_params": {"gamma": 0.5, "milestones": [100]},
         "train_max_steps": 4, "save_interval_steps": 2,
         "eval_interval_steps": 4, "log_interval_steps": 2,
         "num_save_intermediate_results": 1, "allow_cache": True,
         "sort_window": 2, "num_workers": 2,
         "collater_params": {"pad_frames_to": 128}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU ops beside JAX's thread pools: torch's intra-op threads
    only contend (a 6-step run took 3 s on one thread, 10-48 s on 8)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """The CLIs' dump, written once a test run."""
    return worker.shared(tmp_path_factory, "torch_train_cli_dump",
                         _make_dump)


def _make_dump(root):
    rng = np.random.default_rng(0)
    for utt, t in UTTS:
        h5 = str(root / "dump" / f"{utt}.h5")
        jh5.write_hdf5(h5, "wave", (rng.normal(size=t * 240) * 0.1).astype(
            np.float32))
        jh5.write_hdf5(h5, "hubert", rng.normal(size=(t, IN_DIM)).astype(
            np.float32) * 2 + 1)
        jh5.write_hdf5(h5, "logmel",
                       rng.normal(size=(t, MEL)).astype(np.float32) - 3)
        jh5.write_hdf5(h5, "loud", rng.uniform(-60, 0, (t, 1)).astype(
            np.float32))
        jh5.write_hdf5(h5, "est_lf0_score", rng.uniform(
            40, 80, (t, 1)).astype(np.float32))
        jh5.write_hdf5(h5, "midi", rng.uniform(40, 80, t).astype(np.float32))
        f0 = rng.uniform(150, 300, (t, 1)).astype(np.float32)
        f0[: t // 10] = 0.0
        jh5.write_hdf5(h5, "f0", f0)
    return root


def _yaml(path, **overrides):
    path.write_text(yaml.safe_dump(dict(TRAIN, **overrides)))
    return str(path)


def test_compute_statistics_matches_jax(dump, tmp_path):
    """Both CLIs over the dump: the same arrays through a plain
    ``joblib.load`` and through the port's ``load_scalers``."""
    from serenade_tpu.bin.compute_statistics import main as jax_main
    import sys

    cfg = _yaml(tmp_path / "c.yml")
    old, sys.argv = sys.argv, ["compute_statistics", "--rootdir",
                               str(dump / "dump"), "--dumpdir",
                               str(tmp_path / "jax"), "--config", cfg]
    try:
        jax_main()
    finally:
        sys.argv = old
    pstats.main(["--rootdir", str(dump / "dump"), "--dumpdir",
                 str(tmp_path / "port"), "--config", cfg])
    want = joblib.load(str(tmp_path / "jax" / "stats.joblib"))
    path = str(tmp_path / "port" / "stats.joblib")
    for got in (joblib.load(path), load_scalers(path)):
        assert sorted(got) == ["hubert", "logmel", "loud", "score"]
        for feat, attrs in (("hubert", ("mean_", "var_", "scale_")),
                            ("logmel", ("mean_", "var_", "scale_")),
                            ("score", ("data_min_", "data_max_")),
                            ("loud", ("data_min_", "data_max_"))):
            assert got[feat].n_samples_seen_ == want[feat].n_samples_seen_
            for attr in attrs:
                np.testing.assert_array_equal(getattr(got[feat], attr),
                                              getattr(want[feat], attr))


@pytest.fixture(scope="module")
def trained(dump, tmp_path_factory):
    """Statistics, 4 steps of ssc_train (saves at 2 and 4, eval samples at
    4), then ``--resume latest`` to 6."""
    root = tmp_path_factory.mktemp("train")
    cfg = _yaml(root / "train.yml")
    pstats.main(["--rootdir", str(dump / "dump"), "--dumpdir", str(root),
                 "--config", cfg])
    stats = str(root / "stats.joblib")
    exp = root / "exp"
    argv = _train_argv(dump, stats, exp, "--model-axis", "1", "--seed", "3")
    ptrain.main(argv + ["--config", cfg])
    after4 = pckpt.restore_checkpoint(str(exp / "checkpoint-4steps"))
    ptrain.main(argv + ["--config", _yaml(root / "more.yml",
                                          train_max_steps=6),
                        "--resume", "latest"])
    return dict(root=root, exp=exp, stats=stats, after4=after4)


def _train_argv(dump, stats, outdir, *extra):
    return ["--train-dumpdir", str(dump / "dump"), "--dev-dumpdir",
            str(dump / "dump"), "--stats", stats, "--outdir", str(outdir),
            "--device", "cpu", *extra]


def test_train_resume_decode_chain(dump, trained, tmp_path):
    """The run writes its config, checkpoints at 2, 4 and (resumed from
    4) 6 with the optimizer state and the eval samples; the port's
    decode reads the latest checkpoint and writes finite mels."""
    exp = trained["exp"]
    config = yaml.safe_load((exp / "config.yml").read_text())
    assert config["model_params"] == MODEL_PARAMS
    assert config["train_max_steps"] == 6 and config["resume"] == "latest"
    names = sorted(n for n in os.listdir(exp) if n.startswith("checkpoint"))
    assert names == ["checkpoint-2steps", "checkpoint-4steps",
                     "checkpoint-6steps"]
    assert os.listdir(exp / "predictions") == ["4steps"]
    assert "sample0_mel.png" in os.listdir(exp / "predictions" / "4steps")
    last = pckpt.restore_checkpoint(str(exp / "checkpoint-6steps"))
    assert last["meta"] == {"step": 6, "epochs": 1}   # 3 steps an epoch
    assert last["opt_state"]["count"] == 6
    assert last["opt_state"]["mu"]["encoder.conv_in.v"].dtype == \
        torch.bfloat16
    # the resumed run started from step 4's state: its moments moved on
    assert not torch.equal(last["opt_state"]["nu"]["encoder.conv_in.v"],
                           trained["after4"]["opt_state"]["nu"][
                               "encoder.conv_in.v"])
    assert set(last["params"]) == set(Serenade(**MODEL_PARAMS).state_dict())

    out = tmp_path / "decoded"
    pdecode.main(["--dumpdir", str(dump / "dump"), "--stats",
                  trained["stats"], "--outdir", str(out), "--checkpoint",
                  pckpt.find_latest_checkpoint(str(exp)),
                  "--n-timesteps", "2", "--batch-size", "2",
                  "--device", "cpu"])
    decoded = sorted(f for f in os.listdir(out) if f.endswith(".h5"))
    assert len(decoded) >= len(UTTS)
    frames = dict(UTTS)
    for name in decoded:
        mel = jh5.read_hdf5(str(out / name), "mel")
        utt = next(u for u in frames if name.startswith(u))
        assert mel.shape == (frames[utt], MEL), name
        assert np.isfinite(mel).all(), name


def test_init_checkpoint_with_load_and_freeze_mods(dump, trained, tmp_path):
    """``--init-checkpoint`` from the run's step-4 checkpoint with
    ``load_mods: [params/encoder]`` and ``freeze_mods: [params/encoder,
    params/gst/stl]``: after 2 steps the frozen tensors equal the source's
    encoder and the fresh init's style tokens bit for bit, the rest moved,
    and the optimizer holds no moments for the frozen."""
    out = tmp_path / "ft"
    src = trained["after4"]["params"]
    cfg = _yaml(tmp_path / "ft.yml", train_max_steps=2,
                save_interval_steps=100, eval_interval_steps=100,
                load_mods=["params/encoder"],
                freeze_mods=["params/encoder", "params/gst/stl"])
    ptrain.main(_train_argv(
        dump, trained["stats"], out, "--seed", "5", "--config", cfg,
        "--init-checkpoint", str(trained["exp"] / "checkpoint-4steps")))
    ck = pckpt.restore_checkpoint(str(out / "checkpoint-2steps"))
    init = init_params_(Serenade(**MODEL_PARAMS), seed=5).state_dict()
    for name, t in ck["params"].items():
        if name.startswith("encoder."):
            assert torch.equal(t, src[name]), name
        elif name.startswith("gst.stl."):
            assert torch.equal(t, init[name]), name
        else:
            assert not torch.equal(t, init[name]), name
    assert not any(n.startswith(("encoder.", "gst.stl."))
                   for n in ck["opt_state"]["mu"])


def test_init_checkpoint_from_reference_pkl(dump, trained, tmp_path):
    """``--init-checkpoint`` from a reference torch ``.pkl``: the run's
    model takes the converted parameters (its GST on the checkpoint's
    BatchNorm statistics, recorded in config.yml); with every module
    frozen they stay exactly the converted ones."""
    pkl = tmp_path / "checkpoint-100steps.pkl"
    twin = _build_torch_twin()
    torch.save({"model": twin.state_dict()}, str(pkl))
    out = tmp_path / "from_pkl"
    cfg = _yaml(tmp_path / "pkl.yml", train_max_steps=1,
                save_interval_steps=100, eval_interval_steps=100,
                freeze_mods=["params/"])
    ptrain.main(_train_argv(dump, trained["stats"], out, "--config", cfg,
                            "--init-checkpoint", str(pkl)))
    config = yaml.safe_load((out / "config.yml").read_text())
    assert config["model_params"]["gst_norm_type"] == "frozen_batch"
    want = convert_serenade(twin.state_dict(), config["model_params"])
    got = pckpt.restore_checkpoint(str(out / "checkpoint-1steps"))["params"]
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name].float()), name


# ---------------------------------------------------------------------------
# freezing, transfer, the masked optimizer
# ---------------------------------------------------------------------------

PREFIXES = (["params/encoder", "params/gst"],
            ["params/cfm_decoder/estimator/down", "params/gst/stl"],
            ["params/gst/ref_enc/MaskedGRU_0"],
            ["params/cfm"])


@pytest.mark.parametrize("prefixes", PREFIXES)
def test_freeze_mask_selects_jax_parameters(jax_model, prefixes):
    """The port's mask over its parameter names equals JAX's over the flax
    leaves each name is made from; every bridge path is a JAX leaf."""
    _, params = jax_model
    model = _port(params)
    jmask = jio._flatten(jio.freeze_mask(params, prefixes))
    table = flax_paths(model)
    assert {p for ps in table.values() for p in ps} == set(jmask)
    mask = model_io.freeze_mask(model, prefixes)
    assert set(mask) == set(dict(model.named_parameters()))
    for name, paths in table.items():
        assert {jmask[p] for p in paths} == {mask[name]}, name
    assert 0 < sum(not v for v in mask.values()) < len(mask)


def test_transfer_params_matches_jax(jax_model):
    """The encoder and the GST's GRU from a second tree; the rest kept.
    A prefix that matches nothing raises KeyError, a shape that differs
    ValueError, on both sides."""
    _, params = jax_model
    rng = np.random.default_rng(7)
    other = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(size=a.shape)).astype(np.float32), params)
    modules = ["params/encoder", "params/gst/ref_enc/MaskedGRU_0"]
    want = jio.transfer_params(params, other, modules)
    model = _port(params)
    src = state_dict_from_flax(model, other)
    got = model_io.transfer_params(model, src, modules)
    for name, value in state_dict_from_flax(model, _np(want)).items():
        assert torch.equal(got[name], value), name
    assert model_io.filter_modules(model, modules) == modules

    with pytest.raises(KeyError, match="params/nothing"):
        jio.transfer_params(params, other, ["params/nothing"])
    with pytest.raises(KeyError, match="params/nothing"):
        model_io.transfer_params(model, src, ["params/nothing"])
    bad = dict(src, **{"encoder.conv_in.v": torch.zeros(3, 3, 3)})
    jbad = jax.tree_util.tree_map(lambda a: a, other)
    jbad["params"]["encoder"]["conv_in"]["v"] = np.zeros((3, 3, 3))
    with pytest.raises(ValueError, match="shape mismatch"):
        jio.transfer_params(params, jbad, ["params/encoder"])
    with pytest.raises(ValueError, match="shape mismatch"):
        model_io.transfer_params(model, bad, ["params/encoder"])


def _subtree(tree):
    """The encoder, the GST and the estimator's time MLP of a full tree."""
    p = tree["params"]
    return {"params": {"encoder": p["encoder"], "gst": p["gst"],
                       "cfm_decoder": {"estimator": {"time_mlp": p[
                           "cfm_decoder"]["estimator"]["time_mlp"]}}}}


def _with_subtree(tree, sub):
    """``tree`` with :func:`_subtree`'s parts taken from ``sub``."""
    out = jax.tree_util.tree_map(lambda a: a, tree)
    p, q = out["params"], sub["params"]
    p["encoder"], p["gst"] = q["encoder"], q["gst"]
    p["cfm_decoder"]["estimator"]["time_mlp"] = q["cfm_decoder"][
        "estimator"]["time_mlp"]
    return out


def test_masked_optimizer_matches_optax_multi_transform(jax_model):
    """3 updates of the recipe's chain (clip at 1.0, AdamW; f32 moments,
    so that a clip scale one rounding apart cannot flip a bf16 moment) with
    ``params/encoder`` and ``params/gst/ref_enc`` frozen, against
    ``optax.multi_transform``, over the encoder, the GST and the
    estimator's time MLP (a subtree keeps JAX's compile short): the clip
    counts the trainable gradients only (their norm is above 1 and all
    gradients' further above), the frozen tensors stay equal bit for bit
    and hold no moments, the rest within f32 rounding (1e-6 relative);
    the returned norm is that of all gradients."""
    _, full = jax_model
    prefixes = ["params/encoder", "params/gst/ref_enc"]
    config = {"optimizer_type": "AdamW",
              "optimizer_params": {"lr": 1e-2, "mu_dtype": "float32"},
              "grad_norm": 1.0}
    params = _subtree(full)
    model = _port(full)
    leaves = set(jio._flatten(params))
    names = {n for n, ps in flax_paths(model).items() if set(ps) <= leaves}
    mask = {n: t for n, t in model_io.freeze_mask(model, prefixes).items()
            if n in names}
    assert 0 < sum(mask.values()) < len(mask)
    tparams = {n: t.detach().clone() for n, t in model.state_dict().items()
               if n in mask}
    before = {n: t.clone() for n, t in tparams.items()}
    opt, _ = build_optimizer(config, trainable_mask=mask)
    state = opt.init(tparams)
    assert set(state["mu"]) == {n for n, t in mask.items() if t}
    tx, _ = jax_build_optimizer(
        config, trainable_mask=jio.freeze_mask(params, prefixes))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    jupdate = jax.jit(tx.update)
    rng = np.random.default_rng(9)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: (0.05 * rng.normal(size=a.shape)).astype(np.float32),
            full)
        gsd = state_dict_from_flax(model, grads)
        norm = opt.update(tparams, {n: gsd[n] for n in tparams}, state)
        jg = jax.tree_util.tree_map(jnp.asarray, _subtree(grads))
        updates, jstate = jupdate(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)),
                                   rtol=1e-6)
    want = state_dict_from_flax(model, _with_subtree(full, _np(jparams)))
    for name, t in tparams.items():
        if mask[name]:
            assert not torch.equal(t, before[name]), name
            np.testing.assert_allclose(t.numpy(), want[name], rtol=1e-6,
                                       atol=1e-7, err_msg=name)
        else:
            assert torch.equal(t, before[name]), name
            assert torch.equal(want[name], before[name]), name


# ---------------------------------------------------------------------------
# remat, the parameter table, the refusals
# ---------------------------------------------------------------------------


def test_remat_gradients_equal_plain():
    """``remat: true`` (the estimator under torch.utils.checkpoint) gives
    the same losses and gradients, bit for bit, as without, with dropout
    0.1 drawn from one generator: the recomputation replays the dropout
    masks, and the generator ends where the plain run leaves it."""
    cfg = dict(CFG, dropout=0.1)
    rng = np.random.default_rng(4)
    b, t = 2, 64
    batch = (torch.from_numpy(rng.normal(size=(b, t, 32)).astype(
                 np.float32)), torch.tensor([64, 45]),
             torch.from_numpy(rng.normal(size=(b, t, 80)).astype(np.float32)),
             torch.rand(b, t, 1, generator=torch.Generator().manual_seed(1)),
             torch.rand(b, t, 1, generator=torch.Generator().manual_seed(2)))
    out = {}
    for remat in (False, True):
        model = init_params_(Serenade(**cfg, dtype="float32", remat=remat),
                             seed=3)
        gen = torch.Generator().manual_seed(7)
        res = model(*batch, generator=gen)
        res["loss"].backward()
        out[remat] = (res["loss"].detach(),
                      {n: p.grad for n, p in model.named_parameters()},
                      torch.rand(4, generator=gen))
    assert torch.equal(out[True][0], out[False][0])
    for name, g in out[False][1].items():
        assert torch.equal(out[True][1][name], g), name
    assert torch.equal(out[True][2], out[False][2])


def test_parameter_table_at_full_width():
    """The CLI's table of the full-width recipe model totals 84.3 M (built
    on the meta device: no memory)."""
    with torch.device("meta"):
        model = Serenade(**configs.serenade_config())
    table = ptrain.count_parameter_table(model.state_dict())
    total = int(table.splitlines()[-1].split()[-1].replace(",", ""))
    assert round(total / 1e6, 1) == 84.3
    assert [line.split()[0] for line in table.splitlines()[1:-1]] == [
        "cfm_decoder", "encoder", "gst"]


# a mesh the world (one process here) does not have, refused by name
REFUSED = {
    "model_axis": (["--model-axis", "2"], {}, SystemExit,
                   "--model-axis 2 needs 2 ranks.*torchrun"),
    "data_axis": (["--data-axis", "2"], {}, SystemExit,
                  "--data-axis 2 .* needs 2 ranks.*torchrun"),
    "zero1": (["--zero1", "--data-axis", "4"], {}, SystemExit,
              "--data-axis 4 .* needs 4 ranks"),
    "zero1_config": (["--data-axis", "2", "--model-axis", "2"],
                     {"zero1": True}, SystemExit, "needs 4 ranks"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_train_cli_refuses_by_name(tmp_path, case):
    """A launch whose world size is not data x model is refused before
    any file is read (the dump and statistics named here do not exist);
    the layouts themselves run under a gloo group in
    ``tests/test_torch_parallel.py``."""
    argv, overrides, exc, match = REFUSED[case]
    cfg = _yaml(tmp_path / "c.yml", **overrides)
    with pytest.raises(exc, match=match):
        ptrain.main(["--train-dumpdir", "nowhere", "--dev-dumpdir",
                     "nowhere", "--stats", "none.joblib", "--outdir",
                     str(tmp_path / "exp"), "--config", cfg, "--device",
                     "cpu"] + argv)
    assert not os.path.exists(tmp_path / "exp")


VARIANT_TYPES = {"model": "SerenadeNew", "trainer": "SSCTrainerNew",
                 "collater": "SSCCollaterNew", "dataset": "FeatsDatasetNew"}


@pytest.mark.parametrize("kind", sorted(VARIANT_TYPES))
def test_variant_types_resolve_and_build(dump, kind, tmp_path):
    """The F0-fluctuation variant's four types resolve through the
    registry the train CLI reads, and each builds: the model with two more
    conditioning channels, the trainer's batch map, the collater's padded
    ``f0_flucs``, the dataset's unscaled ``f0_fluc``."""
    from serenade_tpu_torch.config import resolve

    cls = resolve(kind, VARIANT_TYPES[kind])
    assert cls.__name__ == VARIANT_TYPES[kind]
    if kind == "model":
        model = cls(**MODEL_PARAMS)
        plain = Serenade(**MODEL_PARAMS)
        assert model.uses_f0_fluc and model.fluc_channels == 2
        grew = {k: (v.shape, plain.state_dict()[k].shape)
                for k, v in model.state_dict().items()
                if v.shape != plain.state_dict()[k].shape}
        assert grew and all(a[1] == b[1] + 2 for a, b in grew.values())
    elif kind == "trainer":
        assert cls.BATCH_RENAME["f0_flucs"] == "f0_fluc"
        assert cls({}, None, type("S", (), {"step": 0})(), [],
                   writer=object(), outdir=str(tmp_path)).steps == 0
    elif kind == "collater":
        items = [{"hubert": np.ones((t, 2)), "logmel": np.ones((t, 3)),
                  "loud": np.ones((t, 1)), "score": np.ones((t, 1)),
                  "f0_fluc": np.full((t, 1), 0.5)} for t in (70, 40)]
        out = cls()(items)
        assert out["f0_flucs"].shape == (2, 128, 1)
        assert out["f0_flucs"][1, :40].min() == 0.5 == \
            out["f0_flucs"][1, :40].max()
        assert not out["f0_flucs"][1, 40:].any()
    else:
        root = tmp_path / "d"
        path = str(root / f"{UTTS[0][0]}.h5")
        for key in ("wave", "hubert", "logmel", "loud", "est_lf0_score",
                    "midi", "f0"):
            jh5.write_hdf5(path, key, jh5.read_hdf5(
                str(dump / "dump" / f"{UTTS[0][0]}.h5"), key))
        fluc = np.linspace(-0.1, 0.1, UTTS[0][1]).astype(np.float32)
        jh5.write_hdf5(path, "f0_fluc", fluc)
        item = cls(str(root), scaler=load_scalers(str(
            _stats(dump, tmp_path))))[0]
        np.testing.assert_array_equal(item["f0_fluc"], fluc[:, None])


def _stats(dump, tmp_path):
    pstats.main(["--rootdir", str(dump / "dump"), "--dumpdir",
                 str(tmp_path), "--config", _yaml(tmp_path / "s.yml")])
    return tmp_path / "stats.joblib"


def test_help_says_the_init_is_the_ports_own(capsys):
    with pytest.raises(SystemExit):
        ptrain.main(["--help"])
    assert "not the JAX package's" in " ".join(capsys.readouterr().out
                                               .split())
