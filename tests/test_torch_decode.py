"""Decode end to end: the port's readers, checkpoints, converters, the
experiment-dir Converter and the decode CLI against the JAX package.

The readers (h5 dumps, ``stats.joblib``, ``config.yml``) and both
reference converters are held against JAX's on the same files; the
decode CLIs (``serenade_tpu.bin.ssc_decode`` and
``serenade_tpu_torch.bin.ssc_decode``) run on one tiny dump with the same
reference torch ``.pkl`` of the Serenade twin (frozen-BatchNorm GST) and
of the HiFiGAN twin, at temperature 0, where both sides start from x0 = 0.
Small widths, f32, on the CPU.
"""

import json
import os
import subprocess
import sys

import jax
import joblib
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from serenade_tpu import checkpoint as jckpt
from serenade_tpu.datasets.feats_dataset import FeatsDataset as JaxFeatsDataset
from serenade_tpu.models.convert_serenade import (
    convert_serenade as jax_convert_serenade,
)
from serenade_tpu.models.serenade import Serenade as JaxSerenade
from serenade_tpu.ops import f0_stats as jf0
from serenade_tpu.utils import h5 as jh5
from serenade_tpu.utils import scalers as jscalers
from serenade_tpu.vocoder.convert import (
    convert_hifigan_generator as jax_convert_hifigan,
)
from serenade_tpu_torch import checkpoint as pckpt
from serenade_tpu_torch.api import Converter
from serenade_tpu_torch.bin import serve as pserve
from serenade_tpu_torch.bin import ssc_decode as pdecode
from serenade_tpu_torch.config import resolve
from serenade_tpu_torch.convert import state_dict_from_flax
from serenade_tpu_torch.datasets.feats_dataset import FeatsDataset
from serenade_tpu_torch.models.convert_serenade import (
    convert_serenade, to_reference_state_dict,
)
from serenade_tpu_torch.models.serenade import Serenade
from serenade_tpu_torch.ops import f0_stats as pf0
from serenade_tpu_torch.utils import h5 as ph5
from serenade_tpu_torch.utils import scalers as pscalers
from serenade_tpu_torch.vocoder.convert import (
    convert_hifigan_generator, to_reference_generator_state_dict,
)
from serenade_tpu_torch.vocoder.hifigan import HiFiGANGenerator
from serenade_tpu_torch.vocoder.vocoder import generator_layout, load_vocoder
from tests.test_serenade_convert import (
    DEC_CH, ENC_CH, GRU_UNITS, GST_CHANS, GST_DIM, HEAD_DIM, IN_DIM, MEL,
    _build_torch_twin,
)
from tests.test_vocoder import CFG as VOC_CFG, _torch_generator

MODEL_PARAMS = dict(
    input_dim=IN_DIM, output_dim=MEL, encoder_channels=ENC_CH,
    encoder_hidden_dim=24, gst_tokens=10, gst_conv_chans=list(GST_CHANS),
    gst_gru_units=GRU_UNITS, decoder_channels=DEC_CH, gst_embed_dim=GST_DIM,
    decoder_attention_head_dim=HEAD_DIM, dtype="float32")
VOC_CONFIG = {"sampling_rate": 24000, "generator_params": {
    k: [list(d) for d in v] if k == "resblock_dilations" else
    (list(v) if isinstance(v, tuple) else v) for k, v in VOC_CFG.items()}}
# four dump utterances in one length bucket (128), two per style, so a
# random pick has a choice and every conversion group is one shape
UTTS = (("EN_s1_song0_Breathy_Group_0", 100),
        ("EN_s1_song1_Breathy_Group_0", 90),
        ("EN_s1_song2_Falsetto_Group_0", 100),
        ("EN_s1_song3_Falsetto_Group_0", 90))
# mel tolerance: two Euler steps of the UNet after the encoder and GST
# stacks in f32 (tests/test_torch_slice.py); waveforms in f32 within 1e-4,
# which PCM16 holds to 4 steps of 1/32767
MEL_TOL, WAV_TOL, PCM_TOL = 2e-4, 1e-4, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f0(rng, frames):
    """A sung F0 track in Hz with unvoiced stretches (zeros)."""
    f0 = 220.0 * 2 ** (rng.normal(size=frames).cumsum() / 60.0)
    f0[: frames // 8] = 0.0
    f0[frames // 2: frames // 2 + 5] = 0.0
    return f0.astype(np.float32)


# -- numpy helpers: the same code on both sides ------------------------------


@pytest.mark.parametrize("direction", ["up", "down"])
def test_linear_midi_shift_matches_jax(direction):
    rng = np.random.default_rng(1)
    src = _f0(rng, 200)
    ref = _f0(rng, 150) * (1.8 if direction == "up" else 0.55)
    got = pf0.linear_midi_shift(src, ref)
    want = jf0.linear_midi_shift(src, ref)
    np.testing.assert_array_equal(got, want)
    assert np.all(got[src == 0] == 0) and np.all(got[src > 0] > 0)
    assert (got[src > 0] > src[src > 0]).all() == (direction == "up")
    stats = pf0.F0Statistics()
    s, r = stats.estimate([src]), stats.estimate([ref])
    np.testing.assert_array_equal(
        stats.convert(src, s, r), jf0.F0Statistics().convert(src, s, r))


def test_scalers_partial_fit_match_jax():
    rng = np.random.default_rng(2)
    chunks = [rng.normal(size=(n, 5)) * 3 + 1 for n in (40, 7, 1, 90)]
    for name in ("StandardScaler", "MinMaxScaler"):
        got, want = getattr(pscalers, name)(), getattr(jscalers, name)()
        for c in chunks:
            got.partial_fit(c)
            want.partial_fit(c)
        attrs = (("mean_", "var_", "scale_") if name == "StandardScaler"
                 else ("data_min_", "data_max_", "scale_", "min_"))
        for a in attrs + ("n_samples_seen_",):
            np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
        x = rng.normal(size=(6, 5))
        np.testing.assert_array_equal(got.transform(x), want.transform(x))
        np.testing.assert_array_equal(got.inverse_transform(x),
                                      want.inverse_transform(x))


def test_config_files_match_jax(tmp_path):
    """A config the port writes reads back the same through both
    packages' ``load_config``, overrides merged the same way (None
    skipped), each package stamping its version."""
    from serenade_tpu.config import load_config as jax_load_config

    from serenade_tpu_torch import __version__
    from serenade_tpu_torch.config import dump_config, load_config

    cfg = {"model_type": "Serenade", "model_params": MODEL_PARAMS,
           "sampling_rate": 24000, "inference_n_timesteps": 2}
    path = str(tmp_path / "exp" / "config.yml")
    dump_config(cfg, path)
    over = {"sampling_rate": 16000, "solver": None, "batch_size": 4}
    got, want = load_config(path, over), jax_load_config(path, over)
    assert got == want == dict(cfg, version=__version__, sampling_rate=16000,
                               batch_size=4)


# -- the shared files: a dump, statistics, twins and configs ---------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("decode")
    rng = np.random.default_rng(0)
    dump = root / "dump"
    for utt, t in UTTS:
        h5 = str(dump / f"{utt}.h5")
        jh5.write_hdf5(h5, "wave",
                       (rng.normal(size=t * 240) * 0.1).astype(np.float32))
        jh5.write_hdf5(h5, "hubert", rng.normal(size=(t, IN_DIM)).astype(
            np.float32) * 2 + 1)
        jh5.write_hdf5(h5, "logmel",
                       rng.normal(size=(t, MEL)).astype(np.float32) - 3)
        jh5.write_hdf5(h5, "loud", rng.uniform(-60, 0, (t, 1)).astype(
            np.float32))
        jh5.write_hdf5(h5, "est_lf0_score", rng.uniform(
            40, 80, (t, 1)).astype(np.float32))
        jh5.write_hdf5(h5, "midi", rng.uniform(40, 80, t).astype(np.float32))
        jh5.write_hdf5(h5, "f0", _f0(rng, t)[:, None])
    scaler = {"hubert": jscalers.StandardScaler(),
              "logmel": jscalers.StandardScaler(),
              "score": jscalers.MinMaxScaler(),
              "loud": jscalers.MinMaxScaler()}
    for utt, _ in UTTS:
        for feat, key in (("hubert", "hubert"), ("logmel", "logmel"),
                          ("score", "est_lf0_score"), ("loud", "loud")):
            scaler[feat].partial_fit(jh5.read_hdf5(str(dump / f"{utt}.h5"),
                                                   key))
    stats = str(root / "stats.joblib")
    joblib.dump(scaler, stats)

    twin = _build_torch_twin()
    pkl = root / "exp" / "checkpoint-200000steps.pkl"
    pkl.parent.mkdir()
    torch.save({"model": twin.state_dict()}, str(pkl))
    gen = _torch_generator().eval()
    with torch.no_grad():      # weight norm whose g is not the norm of v
        for name, p in gen.named_parameters():
            if name.endswith("weight_g"):
                p.mul_(torch.rand(p.shape, generator=torch.Generator()
                                  .manual_seed(len(name))) + 0.5)
    voc_pkl = root / "vocoder.pkl"
    torch.save({"model": {"generator": gen.state_dict()}}, str(voc_pkl))
    voc_cfg = root / "vocoder.yml"
    voc_cfg.write_text(yaml.safe_dump(VOC_CONFIG))
    voc_stats = str(root / "vocoder_stats.h5")
    jh5.write_hdf5(voc_stats, "mean", rng.normal(size=MEL) - 3)
    jh5.write_hdf5(voc_stats, "scale", rng.uniform(0.5, 2, MEL))
    config = {"sampling_rate": 24000, "model_type": "Serenade",
              "model_params": MODEL_PARAMS,
              "vocoder": {"checkpoint": str(voc_pkl), "config": str(voc_cfg),
                          "stats": voc_stats}}
    (pkl.parent / "config.yml").write_text(yaml.safe_dump(config))
    (root / "config_novoc.yml").write_text(yaml.safe_dump(
        {k: v for k, v in config.items() if k != "vocoder"}))
    return dict(root=root, dump=dump, stats=stats, scaler=scaler, twin=twin,
                pkl=pkl, gen=gen, config=config)


def test_h5_dump_reads_match_jax(files, tmp_path):
    """The same dump through both readers: files, datasets, shapes, scp
    loaders, and FeatsDataset items as dumped."""
    dump = str(files["dump"])
    assert sorted(ph5.find_files(dump, "*.h5")) == sorted(
        jh5.find_files(dump, "*.h5"))
    assert sorted(ph5.find_files(dump, "*.h5", include_root_dir=False)) == \
        sorted(jh5.find_files(dump, "*.h5", include_root_dir=False))
    path = os.path.join(dump, UTTS[1][0] + ".h5")
    keys = ("wave", "hubert", "logmel", "f0", "midi", "missing")
    got, want = ph5.read_hdf5_many(path, keys), jh5.read_hdf5_many(path, keys)
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(ph5.read_hdf5(path, k),
                                      jh5.read_hdf5(path, k))
        assert ph5.dataset_shape(path, k) == jh5.dataset_shape(path, k)
        assert ph5.hdf5_has(path, k) == jh5.hdf5_has(path, k)
    assert ph5.read_hdf5(path + ".no", "hubert") is None
    ph5.write_hdf5(str(tmp_path / "w.h5"), "x", np.arange(6.0))
    ph5.write_hdf5(str(tmp_path / "w.h5"), "x", np.arange(3.0))
    np.testing.assert_array_equal(jh5.read_hdf5(str(tmp_path / "w.h5"), "x"),
                                  np.arange(3.0))
    with pytest.raises(FileExistsError):
        ph5.write_hdf5(str(tmp_path / "w.h5"), "x", 1, is_overwrite=False)
    scp = tmp_path / "feats.scp"
    scp.write_text("".join(f"{u} {dump}/{u}.h5:hubert,loud\n"
                           for u, _ in UTTS))
    got, want = ph5.sniff_feats_scp_loader(str(scp)), \
        jh5.sniff_feats_scp_loader(str(scp))
    assert list(got.keys()) == list(want.keys())
    for u, _ in UTTS:
        np.testing.assert_array_equal(got[u], want[u])

    got = FeatsDataset(dump, return_utt_id=True)
    want = JaxFeatsDataset(dump, return_utt_id=True)
    assert len(got) == len(want) == len(UTTS)
    np.testing.assert_array_equal(got.lengths(), want.lengths())
    np.testing.assert_array_equal(got.lengths("score"), want.lengths("score"))
    for i in range(len(got)):
        (gu, gi), (wu, wi) = got[i], want[i]
        assert gu == wu and set(gi) == set(wi)
        for k in wi:
            np.testing.assert_array_equal(gi[k], wi[k])
    with pytest.raises(KeyError, match="'cyclic_logmel'"):
        FeatsDataset(dump, logmel_type="cyclic_logmel")[0]


def test_checkpoint_rules_match_jax(tmp_path):
    """Step-named discovery (latest, the last n up to a step) and
    averaging (floats summed in f32 in order, other leaves from the last)
    against the JAX package's on Orbax checkpoints of the same params; an
    Orbax checkpoint is refused by name."""
    rng = np.random.default_rng(3)
    trees = [{"enc": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
              "n": np.asarray([i + 1, 7], np.int32)} for i in range(3)]
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    for step, tree in zip((50, 100, 200), trees):
        jckpt.save_checkpoint(str(jroot), step, tree)
        pckpt.save_checkpoint(str(proot), step, {
            "enc.w": torch.from_numpy(tree["enc"]["w"]),
            "n": torch.from_numpy(tree["n"])}, epochs=step // 50)
    for root in (jroot, proot):       # names the rules must skip
        (root / "checkpoint-900steps.tmp").mkdir()
        (root / "checkpoint-final").mkdir()
    name = os.path.basename
    assert name(pckpt.find_latest_checkpoint(str(proot))) == name(
        jckpt.find_latest_checkpoint(str(jroot))) == "checkpoint-200steps"
    for n, max_step in ((2, None), (2, 100), (5, 100), (1, 49)):
        got = pckpt.find_last_checkpoints(str(proot), n, max_step)
        want = jckpt.find_last_checkpoints(str(jroot), n, max_step)
        assert [name(p) for p in got] == [name(p) for p in want]
    for p in ("x/checkpoint-100steps", "x/checkpoint-100steps/",
              "checkpoint-final"):
        assert pckpt.checkpoint_step(p) == jckpt.checkpoint_step(p)
    assert pckpt.find_latest_checkpoint(str(tmp_path / "none")) is None

    paths = pckpt.find_last_checkpoints(str(proot), 2)
    got = pckpt.average_checkpoints(paths)
    want = jckpt.average_checkpoints(
        jckpt.find_last_checkpoints(str(jroot), 2))
    np.testing.assert_array_equal(got["enc.w"].numpy(), want["enc"]["w"])
    np.testing.assert_array_equal(got["n"].numpy(), want["n"])
    assert got["n"].dtype == torch.int32
    meta = pckpt.restore_checkpoint(paths[-1])["meta"]
    assert meta == {"step": 200, "epochs": 4}
    with pytest.raises(ValueError, match="Orbax"):
        pckpt.restore_params_only(str(jroot / "checkpoint-100steps"))
    with pytest.raises(ValueError, match="no checkpoints"):
        pckpt.average_checkpoints([])


def test_convert_serenade_matches_jax(files):
    """The twin's state dict through the port's converter equals JAX's
    converter through the param bridge, tensor for tensor; it maps back
    to the reference's names exactly; and the converted models agree
    through ``inference`` at temperature 0."""
    sd = files["twin"].state_dict()
    got = convert_serenade(sd, MODEL_PARAMS)
    jparams = jax.tree_util.tree_map(np.asarray, jax_convert_serenade(sd))
    model = Serenade(**dict(MODEL_PARAMS, gst_norm_type="frozen_batch"))
    want = state_dict_from_flax(model, jparams)
    assert set(got) == set(want)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    back = to_reference_state_dict(got, MODEL_PARAMS)
    assert set(back) == set(sd)
    again = convert_serenade(back, MODEL_PARAMS)
    assert all(torch.equal(again[k], got[k]) for k in got)

    rng = np.random.default_rng(4)
    b, ts, tr = 2, 128, 64
    src = rng.normal(size=(b, ts, IN_DIM)).astype(np.float32)
    ref = rng.normal(size=(b, tr, IN_DIM)).astype(np.float32)
    mel = rng.normal(size=(b, tr, MEL)).astype(np.float32)
    midi, loud = (rng.random((b, ts, 1)).astype(np.float32)
                  for _ in range(2))
    rmidi, rloud = (rng.random((b, tr, 1)).astype(np.float32)
                    for _ in range(2))
    slen, rlen = np.asarray([128, 101]), np.asarray([64, 40])
    jmodel = JaxSerenade(**dict(MODEL_PARAMS, gst_norm_type="frozen_batch",
                                dtype=jax.numpy.float32))
    mel_j = np.asarray(jax.jit(lambda p, *a: jmodel.apply(
        p, *a, rng=jax.random.key(0), n_timesteps=2, temperature=0.0,
        method="inference"))(jparams, src, slen, midi, loud, ref, rlen, mel,
                             rmidi, rloud))
    model.load_state_dict(got)
    t = torch.from_numpy
    with torch.no_grad():
        mel_p = model.inference(
            t(src), t(slen), t(midi), t(loud), t(ref), t(rlen), t(mel),
            t(rmidi), t(rloud), n_timesteps=2, temperature=0.0,
            x0=torch.zeros(b, tr + ts, MEL)).numpy()
    for i in range(b):
        np.testing.assert_allclose(mel_p[i, :slen[i]], mel_j[i, :slen[i]],
                                   rtol=MEL_TOL, atol=MEL_TOL)


def test_convert_hifigan_matches_jax(files):
    """The HiFiGAN twin (weight norm with g != |v|) through the port's
    converter against JAX's through the param bridge, and the converted
    generator against the twin; the inverse folds back exactly."""
    gen, layout = files["gen"], generator_layout(VOC_CONFIG)
    sd = gen.state_dict()
    got = convert_hifigan_generator(sd, **layout)
    pgen = HiFiGANGenerator(**VOC_CFG)
    want = state_dict_from_flax(pgen, jax.tree_util.tree_map(
        np.asarray, jax_convert_hifigan(sd, **layout)))
    assert set(got) == set(want)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7)
    back = to_reference_generator_state_dict(got, **layout)
    again = convert_hifigan_generator(back, **layout)
    assert all(torch.equal(again[k], got[k]) for k in got)
    torch.save({"model": {"generator": back}}, str(files["root"] / "b.pkl"))
    loaded = load_vocoder(str(files["root"] / "b.pkl"), VOC_CONFIG)
    assert all(torch.equal(loaded[k], got[k]) for k in got)

    pgen.load_state_dict(got)
    c = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, MEL, 48)).astype(np.float32))
    with torch.no_grad():
        ref = gen(c)[0, 0].numpy()
        out = pgen(c.transpose(1, 2))[0, :, 0].numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


# -- the experiment-dir Converter and the server ---------------------------


def _dump_feats(dump, utt):
    raw = jh5.read_hdf5_many(str(dump / f"{utt}.h5"),
                             ("hubert", "logmel", "loud", "est_lf0_score"))
    return {"hubert": raw["hubert"], "logmel": raw["logmel"],
            "loud": raw["loud"], "score": raw["est_lf0_score"]}


@pytest.fixture(scope="module")
def expdirs(files):
    """The twin's params as JAX's converter gives them, as an Orbax
    checkpoint of the JAX package and, through the param bridge, as a port
    checkpoint (beside an older one), under one
    config.yml whose sampler is Euler-2; JAX's ``Converter(expdir)`` at
    temperature 0 converts one dump pair."""
    from serenade_tpu.api import Converter as JaxConverter

    root = files["root"]
    config = dict(files["config"], inference_n_timesteps=2,
                  model_params=dict(MODEL_PARAMS,
                                    gst_norm_type="frozen_batch"))
    jparams = jax.tree_util.tree_map(
        np.asarray, jax_convert_serenade(files["twin"].state_dict()))
    sd = state_dict_from_flax(Serenade(**config["model_params"]), jparams)
    jdir, pdir = root / "exp_jax", root / "exp_port"
    for d in (jdir, pdir):
        d.mkdir()
        (d / "config.yml").write_text(yaml.safe_dump(config))
    jckpt.save_checkpoint(str(jdir), 100, jparams)
    pckpt.save_checkpoint(str(pdir), 100, sd)
    pckpt.save_checkpoint(str(pdir), 50, {k: torch.zeros_like(v)
                                          for k, v in sd.items()})
    src = _dump_feats(files["dump"], UTTS[0][0])
    ref = _dump_feats(files["dump"], UTTS[3][0])
    mel, wav, sr = JaxConverter(str(jdir), files["stats"],
                                temperature=0.0).convert_features(src, ref)
    return dict(pdir=pdir, src=src, ref=ref, mel=mel, wav=wav, sr=sr)


def test_from_expdir_matches_jax(files, expdirs):
    """``Converter.from_expdir`` (latest port checkpoint, stats.joblib,
    the config's Euler-2 and vocoder) against JAX's ``Converter(expdir)``
    on the Orbax checkpoint of the same params; given the loaded params
    in place of the checkpoint, it converts the same."""
    conv = Converter.from_expdir(str(expdirs["pdir"]), files["stats"],
                                 temperature=0.0, device="cpu")
    assert (conv.n_timesteps, conv.solver) == (2, "euler")
    mel, wav, sr = conv.convert_features(expdirs["src"], expdirs["ref"])
    assert sr == expdirs["sr"] == 24000
    np.testing.assert_allclose(mel, expdirs["mel"], rtol=MEL_TOL,
                               atol=MEL_TOL)
    np.testing.assert_allclose(wav, expdirs["wav"], rtol=WAV_TOL,
                               atol=WAV_TOL)
    # a state dict already loaded (as ``--average-n`` gives it) stands in
    # for the checkpoint
    latest = pckpt.find_latest_checkpoint(str(expdirs["pdir"]))
    given = Converter.from_expdir(
        str(expdirs["pdir"]), files["stats"], temperature=0.0, device="cpu",
        params=pckpt.restore_params_only(latest))
    np.testing.assert_array_equal(
        given.convert_features(expdirs["src"], expdirs["ref"])[0], mel)


def test_serve_expdir_with_h5_styles(files, expdirs):
    """``bin/serve.py --expdir`` with a ``stats.joblib`` and a --ref-dict
    of h5 dumps: the style registers from the dump, and a request naming
    it converts as JAX's Converter converts the pair."""
    styles = files["root"] / "styles_serve.json"
    styles.write_text(json.dumps(
        {"Falsetto": str(files["dump"] / f"{UTTS[3][0]}.h5")}))
    args = pserve.build_argparser().parse_args([
        "--expdir", str(expdirs["pdir"]), "--stats", files["stats"],
        "--ref-dict", str(styles), "--temperature", "0", "--device", "cpu",
        "--port", "0", "--max-wait-ms", "1"])
    server, batching = pserve.build_app(args)
    try:
        assert batching.reference_names() == ["Falsetto"]
        mel, _, sr = batching.convert(expdirs["src"], "Falsetto")
        assert sr == 24000
        np.testing.assert_allclose(mel, expdirs["mel"], rtol=MEL_TOL,
                                   atol=MEL_TOL)
    finally:
        server.server_close()
        batching.close()


# -- the decode CLIs -------------------------------------------------------


def _run_clis(files, tmp_path, extra, seed=None):
    """Both CLIs on the dump with the twin .pkl; returns the two outdirs."""
    from serenade_tpu.bin.ssc_decode import main as jax_main

    outs = {}
    for side in ("jax", "port"):
        out = str(tmp_path / side)
        argv = ["--dumpdir", str(files["dump"]), "--stats", files["stats"],
                "--outdir", out, "--checkpoint", str(files["pkl"]),
                "--temperature", "0", "--n-timesteps", "2",
                "--batch-size", "2"] + extra
        if seed is not None:
            np.random.seed(seed)
        if side == "jax":
            old, sys.argv = sys.argv, ["ssc_decode"] + argv
            try:
                jax_main()
            finally:
                sys.argv = old
        else:
            pdecode.main(argv + ["--device", "cpu"])
        outs[side] = out
    assert sorted(os.listdir(outs["jax"])) == sorted(os.listdir(outs["port"]))
    return outs["jax"], outs["port"]


def _wav(path):
    sr, x = wavfile.read(path)
    return sr, x.astype(np.int32)


def test_decode_clis_match(files, tmp_path):
    """``--ref-dict`` with the vocoder: the same files, wavs within
    ``PCM_TOL`` steps, equal lf0 h5s; then random styles from a seeded
    ``np.random`` without a vocoder: the same references picked (their
    wavs equal) and mels within ``MEL_TOL``."""
    ref_dict = tmp_path / "styles.json"
    dump = files["dump"]
    ref_dict.write_text(json.dumps({
        "Breathy": str(dump / f"{UTTS[0][0]}.h5"),
        "Mixed_Voice": str(dump / f"{UTTS[3][0]}.h5")}))
    jout, pout = _run_clis(files, tmp_path / "ref_dict",
                           ["--ref-dict", str(ref_dict)])
    names = sorted(os.listdir(jout))
    # 4 sources x 2 styles, less the two that name Breathy
    assert sum(n.endswith(".h5") for n in names) == 6
    assert "00_Breathy_reference.wav" in names
    for n in names:
        if n.endswith(".wav"):
            (sj, xj), (sp, xp) = _wav(f"{jout}/{n}"), _wav(f"{pout}/{n}")
            assert sj == sp and xj.shape == xp.shape
            # the gt and reference wavs are copied from the dump exactly;
            # only the conversions {utt}_{style}.wav are computed
            copied = n.endswith("_gt.wav") or n.startswith("00_")
            tol = 0 if copied else PCM_TOL
            assert np.abs(xj - xp).max() <= tol, n
        else:
            np.testing.assert_array_equal(ph5.read_hdf5(f"{pout}/{n}", "lf0"),
                                          jh5.read_hdf5(f"{jout}/{n}", "lf0"))
            assert not ph5.hdf5_has(f"{pout}/{n}", "mel")

    jout, pout = _run_clis(files, tmp_path / "random",
                           ["--config", str(files["root"] /
                                            "config_novoc.yml")], seed=3)
    names = sorted(os.listdir(jout))
    assert {n for n in names if n.startswith("00_")} == {
        "00_Breathy_reference.wav", "00_Falsetto_reference.wav"}
    for n in names:
        if n.endswith(".wav"):
            np.testing.assert_array_equal(_wav(f"{jout}/{n}")[1],
                                          _wav(f"{pout}/{n}")[1])
        else:
            np.testing.assert_array_equal(ph5.read_hdf5(f"{pout}/{n}", "lf0"),
                                          jh5.read_hdf5(f"{jout}/{n}", "lf0"))
            np.testing.assert_allclose(ph5.read_hdf5(f"{pout}/{n}", "mel"),
                                       jh5.read_hdf5(f"{jout}/{n}", "mel"),
                                       rtol=MEL_TOL, atol=MEL_TOL)


def test_decode_core_batches_as_lone_conversions(files):
    """The core's chunks: grouped by bucket pair, cut at the batch size,
    a style named in the utterance id skipped; each output equal to a lone
    ``convert_features`` from its own noise row (f32, CPU)."""
    conv = Converter(dict(MODEL_PARAMS, gst_norm_type="frozen_batch"),
                     convert_serenade(files["twin"].state_dict(),
                                      MODEL_PARAMS),
                     pscalers.load_stats(files["stats"]), n_timesteps=1,
                     device="cpu")
    rng = np.random.default_rng(6)
    sources = {f"EN_s1_x{i}_Breathy_Group_0": {
        "hubert": rng.normal(size=(t, IN_DIM)), "score": rng.random(t) * 80,
        "loud": -rng.random(t) * 60, "lf0": _f0(rng, t)}
        for i, t in enumerate((70, 120, 65, 200))}
    references = {"a": {"hubert": rng.normal(size=(60, IN_DIM)),
                        "score": rng.random(60) * 80,
                        "loud": -rng.random(60) * 60,
                        "logmel": rng.normal(size=(60, MEL)) - 3,
                        "f0": _f0(rng, 60)}}
    styles = {u: {"Breathy": "a", "Falsetto": "a"} for u in sources}
    plan = pdecode.plan_chunks(sources, styles, references, 2)
    assert [(k, [u.split("_")[2] for u, _, _ in c]) for k, c in plan] == [
        ((128, 64), ["x0", "x1"]), ((128, 64), ["x2"]), ((256, 64), ["x3"])]
    results = [r for _, rs in pdecode.decode_core(conv, sources, styles,
                                                  references, 2)
               for r in rs]
    assert [r["style"] for r in results] == ["Falsetto"] * 4
    for r in results:
        src, ref = sources[r["utt_id"]], references[r["ref_key"]]
        mel, _, _ = conv.convert_features(src, ref, x0=r["x0"])
        np.testing.assert_allclose(r["mel"], mel, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            r["lf0"], pf0.linear_midi_shift(src["lf0"], ref["f0"]).astype(
                np.float32))


# -- the import rule, and refusals -----------------------------------------


def test_readers_load_without_jax_sklearn_or_their_packages(files, tmp_path):
    """In a fresh interpreter: ``load_stats`` of the JAX-written
    stats.joblib and of one pickled with sklearn's classes leaves
    serenade_tpu and sklearn out of ``sys.modules``; with h5py, pyyaml and
    joblib blocked the readers import and raise naming the package."""
    sk = pytest.importorskip("sklearn.preprocessing")
    rng = np.random.default_rng(7)
    x, y = rng.normal(size=(30, 3)), rng.random((30, 1))
    sk_stats = str(tmp_path / "sk.joblib")
    joblib.dump({"hubert": sk.StandardScaler().fit(x),
                 "logmel": sk.StandardScaler().fit(x),
                 "score": sk.MinMaxScaler().fit(y),
                 "loud": sk.MinMaxScaler().fit(y)}, sk_stats)
    code = f"""
import json, sys
from serenade_tpu_torch.utils.scalers import load_stats
out = {{"jax": load_stats({files["stats"]!r}),
        "sk": load_stats({sk_stats!r})}}
out = {{k: {{f: {{s: v.tolist() for s, v in d.items()}} for f, d in o.items()}}
        for k, o in out.items()}}
out["modules"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("serenade_tpu", "sklearn"))
sys.modules.update(h5py=None, yaml=None, joblib=None)
from serenade_tpu_torch.utils import h5
from serenade_tpu_torch import config
errors = []
for fn, arg in ((h5.read_hdf5, ({str(files["dump"] / (UTTS[0][0] + ".h5"))!r},
                                "hubert")),
                (config.load_config, ({str(files["pkl"].parent /
                                           "config.yml")!r},)),
                (load_stats, ({files["stats"]!r},))):
    try:
        fn(*arg)
    except ImportError as exc:
        errors.append(str(exc))
out["errors"] = errors
print(json.dumps(out))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["modules"] == []
    assert [e.split(" needs the ")[-1] for e in out["errors"]] == [
        "h5py package", "pyyaml package", "joblib package"]
    sc = files["scaler"]
    np.testing.assert_array_equal(out["jax"]["hubert"]["mean"],
                                  sc["hubert"].mean_)
    np.testing.assert_array_equal(out["jax"]["loud"]["max"],
                                  sc["loud"].data_max_)
    np.testing.assert_allclose(out["sk"]["hubert"]["scale"], x.std(0),
                               rtol=1e-12)
    np.testing.assert_array_equal(out["sk"]["score"]["min"], y.min(0))


def _decode_argv(files, *extra):
    return ["--dumpdir", str(files["dump"]), "--stats", files["stats"],
            "--outdir", str(files["root"] / "refused"),
            "--checkpoint", str(files["pkl"]), "--device", "cpu", *extra]


def _orbax_dir(f):
    """A directory with an Orbax marker file at its top."""
    d = f["root"] / "orbax_vocoder"
    d.mkdir(exist_ok=True)
    (d / "_CHECKPOINT_METADATA").write_text("")
    return str(d)


REFUSALS = {
    "unknown_model": (lambda f: resolve("model", "NuSVC"), KeyError,
                      "registered: \\['NUSVC', 'Serenade', 'SerenadeNew'\\]"),
    "vocoder_orbax_dir": (lambda f: load_vocoder(_orbax_dir(f), VOC_CONFIG),
                          ValueError, "Orbax"),
    "data_mesh": (lambda f: Converter.from_expdir(
        str(f["pkl"].parent), f["stats"], data_mesh=2, device="cpu"),
        NotImplementedError, "data_mesh"),
    "quantize": (lambda f: Converter.from_expdir(
        str(f["pkl"].parent), f["stats"], quantize="int4", device="cpu"),
        ValueError, "unknown quantize mode 'int4'"),
    "decode_data_axis": (lambda f: pdecode.main(
        _decode_argv(f, "--data-axis", "2")), SystemExit, "--data-axis"),
    "decode_feats_scp": (lambda f: pdecode.main(
        _decode_argv(f, "--feats-scp", "feats.scp")), SystemExit,
        "--feats-scp"),
    "decode_average_pkl": (lambda f: pdecode.main(
        _decode_argv(f, "--average-n", "2")), SystemExit, "--average-n"),
    "serve_checkpoint_without_expdir": (lambda f: pserve.build_app(
        pserve.build_argparser().parse_args([
            "--stats", f["stats"], "--checkpoint", str(f["pkl"]),
            "--device", "cpu"])), SystemExit, "--checkpoint needs --expdir"),
    "serve_expdir_with_params": (lambda f: pserve.build_app(
        pserve.build_argparser().parse_args([
            "--expdir", str(f["pkl"].parent), "--stats", f["stats"],
            "--params", "p.pt", "--device", "cpu"])), SystemExit,
        "--expdir replaces --params"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refused_by_name(files, case):
    fn, exc, match = REFUSALS[case]
    with pytest.raises(exc, match=match):
        fn(files)
