"""The port's training loop against the JAX package's, on the CPU.

The collater, the dataset's training options, the loader and the
device-resident batches of ``serenade_tpu_torch`` against
``serenade_tpu``'s on one tiny h5 dump, exactly; then
``trainers.SSCTrainer`` against JAX's over 6 steps across an epoch
boundary, from the same parameters (JAX's seeded init through
``convert.py``), the same dump and loader, and JAX's own draws from its
key chain handed to the port's step; a save at step 3 (async and
synchronous) and a resume from it on both sides.  Small widths, f32,
dropout 0 (as ``tests/test_torch_train.py``).
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch

from serenade_tpu.collaters.ssc import SSCCollater as JaxCollater
from serenade_tpu.datasets.device_cache import (
    DeviceResidentData as JaxDeviceResidentData,
)
from serenade_tpu.datasets.feats_dataset import FeatsDataset as JaxDataset
from serenade_tpu.datasets.loader import ShardedBatchLoader as JaxLoader
from serenade_tpu.models.serenade import Serenade as JaxSerenade
from serenade_tpu.trainers import SSCTrainer as JaxTrainer
from serenade_tpu.trainers import build_optimizer as jax_build_optimizer
from serenade_tpu.trainers import build_train_step as jax_build_train_step
from serenade_tpu.trainers import create_train_state as jax_create_state
from serenade_tpu.utils import h5 as jh5
from serenade_tpu.utils import scalers as jscalers

from serenade_tpu_torch import checkpoint as pckpt
from serenade_tpu_torch.collaters.ssc import SSCCollater
from serenade_tpu_torch.convert import load_params, state_dict_from_flax
from serenade_tpu_torch.datasets.device_cache import DeviceResidentData
from serenade_tpu_torch.datasets.feats_dataset import FeatsDataset
from serenade_tpu_torch.datasets.loader import ShardedBatchLoader
from serenade_tpu_torch.models.serenade import Serenade
from serenade_tpu_torch.trainers import (
    SSCTrainer, build_optimizer, build_train_step, create_train_state,
)
from serenade_tpu_torch.utils import model_io
from serenade_tpu_torch.utils.scalers import load_scalers
from test_torch_train import CFG, _draws, _np
import torch_parallel_worker as worker

IN_DIM, MEL = CFG["input_dim"], CFG["output_dim"]
# the dump: 11 utterances of 40-150 frames (4 of them without the cyclic
# key) and one of 3000 frames, which the collater drops
LENGTHS = (150, 40, 97, 64, 130, 75, 120, 51, 88, 140, 66, 3000)
NO_CYCLIC = (1, 4, 8, 10)


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
    """The loop's dump and statistics, written once a test run."""
    return worker.shared(tmp_path_factory, "torch_train_loop_dump",
                         _make_dump)


def _make_dump(root):
    rng = np.random.default_rng(0)
    scaler = {"hubert": jscalers.StandardScaler(),
              "logmel": jscalers.StandardScaler(),
              "score": jscalers.MinMaxScaler(),
              "loud": jscalers.MinMaxScaler()}
    for i, t in enumerate(LENGTHS):
        h5 = str(root / "dump" / f"utt{i:02d}.h5")
        feats = {"wave": rng.normal(size=t * 4).astype(np.float32),
                 "hubert": rng.normal(size=(t, IN_DIM)).astype(np.float32)
                 * 2 + 1,
                 "logmel": rng.normal(size=(t, MEL)).astype(np.float32) - 3,
                 "loud": rng.uniform(-60, 0, (t, 1)).astype(np.float32),
                 "est_lf0_score": rng.uniform(40, 80, (t, 1)).astype(
                     np.float32),
                 "midi": rng.uniform(40, 80, t).astype(np.float32),
                 "f0": rng.uniform(100, 300, (t, 1)).astype(np.float32)}
        if i not in NO_CYCLIC:
            feats["cyclic_logmel"] = feats["logmel"] + 0.5
        for key, value in feats.items():
            jh5.write_hdf5(h5, key, value)
        for name, key in (("hubert", "hubert"), ("logmel", "logmel"),
                          ("score", "est_lf0_score"), ("loud", "loud")):
            scaler[name].partial_fit(feats[key])
    stats = str(root / "stats.joblib")
    joblib.dump(scaler, stats)
    return dict(dir=str(root / "dump"), stats=stats,
                jax_scaler=joblib.load(stats), scaler=load_scalers(stats))


def _equal_items(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("opts", [
    dict(),
    dict(scaler=True),
    dict(scaler=True, load_keys=("hubert", "logmel", "loud", "score"),
         allow_cache=True),
    dict(scaler=True, logmel_type="cyclic_logmel", logmel_fallback=True),
], ids=["as_dumped", "scaler", "load_keys_cache", "cyclic_fallback"])
def test_dataset_items_match_jax(dump, opts):
    """Every item, twice (the second read from the cache where it is on),
    equal to JAX's in keys, dtypes and values."""
    opts = dict(opts)
    scaled = opts.pop("scaler", False)
    jds = JaxDataset(dump["dir"], scaler=dump["jax_scaler"] if scaled
                     else None, **opts)
    pds = FeatsDataset(dump["dir"], scaler=dump["scaler"] if scaled
                       else None, **opts)
    assert len(pds) == len(jds) == len(LENGTHS)
    np.testing.assert_array_equal(pds.lengths(), jds.lengths())
    for _ in range(2):
        for i in range(len(jds)):
            _equal_items(pds[i], jds[i])
    if opts.get("allow_cache"):
        assert len(pds._cache) == len(LENGTHS)


def test_cyclic_key_missing_without_fallback_raises(dump):
    for cls in (JaxDataset, FeatsDataset):
        ds = cls(dump["dir"], logmel_type="cyclic_logmel")
        with pytest.raises(KeyError, match="cyclic_logmel"):
            ds[NO_CYCLIC[0]]


def _u16(a):
    """bf16 values as their bit patterns."""
    if torch.is_tensor(a):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _equal_batches(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if torch.is_tensor(g):          # bf16 host batches
            assert g.dtype == torch.bfloat16 and str(w.dtype) == "bfloat16"
            np.testing.assert_array_equal(_u16(g), _u16(w), err_msg=k)
        else:
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("params", [
    dict(),
    dict(pad_frames_to=96),
    dict(pad_batch_to=6),
    dict(host_dtype="bfloat16"),
    dict(host_dtype="bfloat16", pad_frames_to=128, pad_batch_to=5),
])
def test_collater_matches_jax(dump, params):
    """Five items including the 3000-frame one (dropped), the rest sorted
    longest first and padded to the bucket or to ``pad_frames_to`` with
    lengths clamped, the batch axis to ``pad_batch_to``; bf16 bit for
    bit."""
    ds = FeatsDataset(dump["dir"], scaler=dump["scaler"])
    items = [ds[i] for i in (3, 11, 0, 7, 5)]
    got = SSCCollater(**params)(items)
    want = JaxCollater(**params)(items)
    _equal_batches(got, want)
    assert len(got["lens"]) == max(4, params.get("pad_batch_to") or 0)


def test_collater_refuses_an_empty_batch(dump):
    ds = FeatsDataset(dump["dir"])
    with pytest.raises(ValueError, match="empty batch"):
        SSCCollater()([ds[11]])


@pytest.mark.parametrize("case", [
    dict(batch_size=3),
    dict(batch_size=3, sort_window=2, num_workers=2),
    dict(batch_size=5, drop_last=False, sort_window=3),
    dict(batch_size=4, shuffle=False, num_workers=3),
    dict(batch_size=2, sort_window=2, num_workers=2, worker_type="process",
         host_dtype="bfloat16"),
], ids=["plain", "sort_threads", "no_drop_last", "ordered", "processes"])
def test_loader_matches_jax_over_two_epochs(dump, case):
    """Two epochs of batches, equal to JAX's in the same order (JAX's
    loader without workers: the workers change nothing of the batches),
    the prefetch thread on; one case with spawned worker processes."""
    case = dict(case)
    dtype = case.pop("host_dtype", None)
    workers = {k: case.pop(k) for k in ("num_workers", "worker_type")
               if k in case}
    jds = JaxDataset(dump["dir"], scaler=dump["jax_scaler"])
    pds = FeatsDataset(dump["dir"], scaler=dump["scaler"],
                       allow_cache=True)
    jl = JaxLoader(jds, JaxCollater(host_dtype=dtype), seed=5,
                   process_index=0, process_count=1, **case)
    pl = ShardedBatchLoader(pds, SSCCollater(host_dtype=dtype), seed=5,
                            **case, **workers)
    try:
        assert len(pl) == len(jl)
        for epoch in range(2):
            want = list(jl)
            got = list(pl)
            assert len(got) == len(want) == len(jl), epoch
            for g, w in zip(got, want):
                _equal_batches(g, w)
        assert pl.epoch == jl.epoch == 2
    finally:
        pl.shutdown()


def test_loader_stops_its_thread_when_left_mid_epoch(dump):
    """A consumer that stops early (a trainer at its last step) leaves no
    prefetch thread behind, and the next epoch starts afresh."""
    import threading

    pl = ShardedBatchLoader(FeatsDataset(dump["dir"]), SSCCollater(),
                            batch_size=2)
    def prefetching():
        return [t for t in threading.enumerate() if t.name == "ssc-prefetch"]

    it = iter(pl)
    next(it)
    assert len(prefetching()) == 1
    it.close()
    assert not prefetching()
    assert len(list(pl)) == len(pl)


def test_device_resident_batches_match_jax(dump):
    """The corpus stacked at ``pad_frames_to`` 128 (the 150- and
    3000-frame items truncated) and two epochs of gathered batches, as
    JAX's ``wrap_step`` hands them to the step."""
    jds = JaxDataset(dump["dir"], scaler=dump["jax_scaler"])
    pds = FeatsDataset(dump["dir"], scaler=dump["scaler"])
    jd = JaxDeviceResidentData(jds, pad_frames_to=128, batch_size=5, seed=3)
    pd = DeviceResidentData(pds, pad_frames_to=128, batch_size=5, seed=3,
                            device="cpu")
    assert len(pd) == len(jd) == len(LENGTHS) // 5
    assert pd.nbytes == sum(a.nbytes for a in jd.arrays.values())
    jstep = jd.wrap_step(lambda state, batch, rng: batch)
    pstep = pd.wrap_step(lambda state, batch, gen: batch)
    for _ in range(2):
        for jb, pb in zip(jd, pd, strict=True):
            np.testing.assert_array_equal(pb["indices"], jb["indices"])
            want = jstep(None, jb, None)
            got = pstep(None, pb, None)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]), k)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

T_LOOP = 128


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """The JAX model and its seeded parameters (numpy, jittered off the
    init's zeros and ones; made once a test run)."""
    params = worker.shared(tmp_path_factory, "torch_train_loop_jax_params",
                           lambda _: _jax_params())
    return JaxSerenade(**CFG, dtype=jnp.float32), params


def _jax_params():
    jmodel = JaxSerenade(**CFG, dtype=jnp.float32)
    key = jax.random.key(0)
    rng = np.random.default_rng(1)
    args = (jnp.asarray(rng.normal(size=(2, T_LOOP, IN_DIM)), jnp.float32),
            jnp.asarray([T_LOOP, 90]),
            jnp.zeros((2, T_LOOP, MEL)), jnp.zeros((2, T_LOOP, 1)),
            jnp.zeros((2, T_LOOP, 1)))
    params = _np(jax.jit(lambda *a: jmodel.init(key, *a, rng=key))(*args))
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        params)
    return params


def _port(params):
    return load_params(Serenade(**CFG, dtype="float32"), params)


# 8 items of the dump (the 3000-frame one left out) at batch 2: 4 steps an
# epoch, so 6 steps cross into the second; every batch padded to 128
# frames, so JAX compiles its step once
LOOP = {"batch_size": 2, "train_max_steps": 6, "log_interval_steps": 1,
        "save_interval_steps": 3, "eval_interval_steps": 1000,
        "optimizer_type": "AdamW",
        "optimizer_params": {"lr": 1e-3, "eps": 1e-3},
        "grad_norm": 1.0, "scheduler_type": "MultiStepLR",
        "scheduler_params": {"gamma": 0.5, "milestones": [4]},
        "collater_params": {"pad_frames_to": T_LOOP}}
SEED = 11


class _Writer:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, key, value, step):
        if key != "train/steps_per_sec":     # a wall-clock rate
            self.scalars[key, step] = float(value)


class _Subset:
    """The first 8 utterances of the dump (all under 3000 frames)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return self.ds[i]


class _JaxDraws:
    """The port's step, fed JAX's draws: the trainer's key chain from
    ``key(SEED + 2)``, split once a step, as JAX's SSCTrainer splits it."""

    def __init__(self, step):
        self.step = step
        self.rng = jax.random.key(SEED + 2)

    def __call__(self, state, batch, generator):
        self.rng, key = jax.random.split(self.rng)
        b, t = np.asarray(batch["x"]).shape[:2]
        return self.step(state, batch, None, draws=_draws(key, b, t))


@pytest.fixture(scope="module")
def jax_step(jax_model):
    jmodel, _ = jax_model
    tx, _ = jax_build_optimizer(LOOP)
    return tx, jax_build_train_step(jmodel, tx, donate=False)


def _jax_run(jax_step, params, dump, outdir, resume=None):
    tx, step = jax_step
    loader = JaxLoader(_Subset(JaxDataset(dump["dir"],
                                          scaler=dump["jax_scaler"])),
                       JaxCollater(pad_frames_to=T_LOOP), batch_size=2,
                       seed=SEED, process_index=0, process_count=1)
    state = jax_create_state(jax.tree_util.tree_map(jnp.asarray, params),
                             tx)
    writer = _Writer()
    trainer = JaxTrainer(LOOP, step, state, loader, writer=writer,
                         outdir=outdir, rng=jax.random.key(SEED + 2))
    # JAX writes only the step-3 checkpoint the resume reads: an Orbax
    # save costs seconds here and changes no logged number
    save = trainer.save
    trainer.save = lambda s: save(s) if s == 3 and not resume else None
    if resume:
        trainer.resume(resume)
        # the same values, uncommitted as the fresh run's: committed
        # arrays would compile the step a second time (~12 s here)
        trainer.state = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a)), trainer.state)
    trainer.run()
    return trainer, writer.scalars


def _port_run(params, dump, outdir, resume=None, async_save=True,
              max_steps=6):
    model = _port(params)
    opt, _ = build_optimizer(LOOP)
    state = create_train_state(model, opt)
    step = _JaxDraws(build_train_step(model, opt, device="cpu"))
    loader = ShardedBatchLoader(
        _Subset(FeatsDataset(dump["dir"], scaler=dump["scaler"])),
        SSCCollater(pad_frames_to=T_LOOP), batch_size=2, seed=SEED)
    writer = _Writer()
    trainer = SSCTrainer(dict(LOOP, async_checkpointing=async_save,
                              train_max_steps=max_steps), step,
                         state, loader, writer=writer, outdir=outdir)
    if resume:
        trainer.resume(resume)
    trainer.run()
    return trainer, writer.scalars


def _same_scalars(got, want):
    """Every logged scalar, within 1e-4 relative (f32 summation order
    through 6 updates, as tests/test_torch_train.py holds its metrics)."""
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-4, atol=1e-6,
                                   err_msg=str(key))


def _held(run):
    """What the tests read of a run, in a form that pickles: the
    trainer's steps, epochs, parameters (numpy or tensors) and save
    times, and its logged scalars."""
    trainer, scalars = run
    params = trainer.state.params
    return (SimpleNamespace(
        steps=trainer.steps, epochs=trainer.epochs,
        save_blocked_s=dict(getattr(trainer, "save_blocked_s", {})),
        state=SimpleNamespace(params=(
            {k: v.detach().clone() for k, v in params.items()}
            if isinstance(params, dict) and all(
                torch.is_tensor(v) for v in params.values())
            else _np(params)))), scalars)


@pytest.fixture(scope="module")
def runs(jax_model, request, tmp_path_factory):
    """The 6-step run on both sides (the port's checkpoints written by
    AsyncSaver, then by synchronous saves in a second run), and both
    sides resumed from step 3; once a test run."""
    return worker.shared(tmp_path_factory, "torch_train_loop_runs",
                         lambda root: _runs(
                             jax_model, request.getfixturevalue("jax_step"),
                             request.getfixturevalue("dump"), root))


def _runs(jax_model, jax_step, dump, root):
    _, params = jax_model
    out = {"root": root}
    out["jax"] = _jax_run(jax_step, params, dump, str(root / "jax"))
    out["port"] = _port_run(params, dump, str(root / "port"))
    out["sync"] = _port_run(params, dump, str(root / "sync"),
                            async_save=False, max_steps=3)
    out["jax_resumed"] = _jax_run(jax_step, params, dump, str(root / "jr"),
                                  resume=str(root / "jax"
                                             / "checkpoint-3steps"))
    out["port_resumed"] = _port_run(params, dump, str(root / "pr"),
                                    resume=str(root / "port"
                                               / "checkpoint-3steps"))
    return {k: v if k == "root" else _held(v) for k, v in out.items()}


def test_trainer_logs_what_jax_logs(jax_model, runs):
    """6 steps across an epoch boundary: the same per-step losses and
    gradient norms as JAX's trainer, and parameters within 2e-5 after."""
    (jtrainer, jscalars), (ptrainer, pscalars) = runs["jax"], runs["port"]
    assert jtrainer.steps == ptrainer.steps == 6
    assert jtrainer.epochs == ptrainer.epochs == 2
    assert {s for _, s in pscalars} == set(range(1, 7))
    _same_scalars(pscalars, jscalars)
    want = state_dict_from_flax(_port(jax_model[1]),
                                _np(jtrainer.state.params))
    for name, p in ptrainer.state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   rtol=0, atol=2e-5, err_msg=name)


def test_async_checkpoint_equals_synchronous(runs):
    """The step-3 checkpoint of the async run and of the synchronous one
    hold the same tensors bit for bit; both carry the step, the epochs
    and the optimizer's count."""
    root = runs["root"]
    a = pckpt.restore_checkpoint(str(root / "port" / "checkpoint-3steps"))
    s = pckpt.restore_checkpoint(str(root / "sync" / "checkpoint-3steps"))
    assert a["meta"] == s["meta"] == {"step": 3, "epochs": 0}
    assert a["opt_state"]["count"] == s["opt_state"]["count"] == 3
    assert runs["sync"][0].save_blocked_s.keys() == {3}
    for part in ("params", "opt_state"):
        flat_a, flat_s = _leaves(a[part]), _leaves(s[part])
        assert flat_a.keys() == flat_s.keys()
        for k in flat_a:
            assert torch.equal(flat_a[k], flat_s[k]), k
    last = pckpt.restore_checkpoint(str(root / "port" / "checkpoint-6steps"))
    assert last["meta"] == {"step": 6, "epochs": 1}


def test_resumed_trainer_logs_what_jax_logs(runs):
    """Both sides resumed from step 3 (parameters, moments, step and
    epochs restored; the draws and the loader restart, as in JAX) log the
    same steps 4-6."""
    (jres, jscalars), (pres, pscalars) = (runs["jax_resumed"],
                                          runs["port_resumed"])
    assert {s for _, s in pscalars} == {4, 5, 6}
    _same_scalars(pscalars, jscalars)
    assert pres.steps == jres.steps == 6


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        elif torch.is_tensor(v):
            out[prefix + k] = v
    return out


def test_resume_restores_state_bit_for_bit_and_checks_structure(
        jax_model, runs, tmp_path):
    """A fresh trainer resumed from a checkpoint holds its parameters,
    moments, optimizer count, step and epochs exactly; a checkpoint of
    another optimizer layout (frozen modules) is refused unless only the
    parameters are asked for."""
    _, params = jax_model
    path = str(runs["root"] / "port" / "checkpoint-6steps")
    saved = pckpt.restore_checkpoint(path)
    model = _port(params)
    opt, _ = build_optimizer(LOOP)
    fresh = SSCTrainer(LOOP, None, create_train_state(model, opt), [],
                       writer=_Writer(), outdir=str(tmp_path / "b"))
    fresh.resume(path)
    assert (fresh.steps, fresh.epochs, fresh.state.step) == (6, 1, 6)
    assert fresh.state.opt_state["count"] == 6
    for name, p in fresh.state.params.items():
        assert torch.equal(p, saved["params"][name]), name
    for part in ("mu", "nu"):
        for name, t in fresh.state.opt_state[part].items():
            assert torch.equal(t, saved["opt_state"][part][name]), name

    mask = model_io.freeze_mask(model, ["params/encoder"])
    opt2, _ = build_optimizer(LOOP, trainable_mask=mask)
    other = SSCTrainer(LOOP, None, create_train_state(_port(params), opt2),
                       [], writer=_Writer(), outdir=str(tmp_path / "c"))
    with pytest.raises(ValueError, match="opt_state"):
        other.resume(path)
    other.resume(path, load_only_params=True)
    assert other.steps == 0 and other.state.opt_state["count"] == 0
    for name, p in other.state.params.items():
        assert torch.equal(p, saved["params"][name]), name
    assert not os.path.exists(str(tmp_path / "c"))
