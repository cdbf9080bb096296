"""Recipe stage 9 through the port (``bin/ssc_postprocessing.py``)
against the JAX package's CLI, on the CPU.

A run of the JAX CLI (``--anasyn --f0-factors 0.5,1.0,2.0``: Harvest
with the voice types' ranges, band aperiodicity, the SiFiGAN from a
released-layout ``.pkl`` written from the JAX package's PyTorch twin)
and the port's CLI on the same wavs: every ``*_anasyn[_fX.XX].wav``
held against JAX's; one run of each on the native host backends.  The
SSC flow (an lf0 h5 beside each wav, aux scalers from a
``stats.joblib``) against JAX's analysis and generator driven as its CLI
drives them; bucketed synthesis against exact-length synthesis; and what
is refused by name.  The wavs are sung-like tones from a seed; three of
them fill a 128-frame bucket and a 256-frame one, so synthesis batches
(padded to a power of two, whose rows draw excitation noise too).
"""

import glob
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch
import yaml

from serenade_tpu.sifigan import SiFiGANGenerator as JaxSiFiGAN
from serenade_tpu.sifigan import features as jfeat
from serenade_tpu.sifigan.convert import load_sifigan_checkpoint as jload
from serenade_tpu.sifigan.torch_twin import SiFiGANGeneratorTorch
from serenade_tpu.utils.audio import read_wav, write_wav
from serenade_tpu.utils.h5 import write_hdf5
from serenade_tpu.utils.scalers import StandardScaler

from serenade_tpu_torch.bin import ssc_postprocessing as post

SR, HOP = 24000, 120
FILTER = dict(resblock_kernel_sizes=[3, 5],
              resblock_dilations=[[1, 3], [1, 3]],
              use_additional_convs=False)
CONFIG = dict(sample_rate=SR, generator=dict(
    in_channels=43, channels=32, upsample_scales=[5, 4, 3, 2],
    upsample_kernel_sizes=[10, 8, 6, 4], filter_network_params=FILTER))
# name, seconds, F0 (Hz): 81 and 101 frames share the 128-frame bucket
WAVS = (("utt_a_Tenor", 0.4, 220.0), ("utt_b_Tenor", 0.5, 196.0),
        ("utt_c_Alto", 0.9, 330.0))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sung(seconds, f0, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    ph = 2 * np.pi * np.cumsum(f0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))) / SR
    x = sum((0.3 / h) * np.sin(h * ph) for h in range(1, 7))
    return (x + 0.005 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The config, a released-layout .pkl from the twin (seeded), and the
    wavs."""
    root = tmp_path_factory.mktemp("post")
    torch.manual_seed(0)
    twin = SiFiGANGeneratorTorch(
        in_channels=43, channels=32, upsample_scales=(5, 4, 3, 2),
        upsample_kernel_sizes=(10, 8, 6, 4), filter_network_params=dict(
            FILTER, resblock_dilations=[(1, 3), (1, 3)]))
    ckpt = root / "sifigan.pkl"
    torch.save({"model": {"generator": twin.state_dict()}}, ckpt)
    cfg = root / "post.yml"
    with open(cfg, "w") as f:
        yaml.safe_dump(CONFIG, f)
    wavs = {name: sung(sec, f0, i) for i, (name, sec, f0) in enumerate(WAVS)}
    return root, str(cfg), str(ckpt), wavs


def _write_wavs(d, wavs):
    os.makedirs(d, exist_ok=True)
    for name, x in wavs.items():
        write_wav(os.path.join(d, f"{name}.wav"), x, SR)


def _run_jax_cli(args):
    from serenade_tpu.bin import ssc_postprocessing as jpost

    old = sys.argv
    sys.argv = ["prog"] + args
    try:
        jpost.main()
    finally:
        sys.argv = old


def test_anasyn_cli_matches_jax_cli(assets):
    """The JAX CLI, then the port's (``--device cpu``) on the same
    directory: the same nine outputs, each of the same length and within
    2e-3 of JAX's (measured 5.2e-4 on peaks near 0.5; PCM16 and JAX's
    f32 CheapTrick sums, which move its mel-cepstra by up to 0.012 from
    their f64 values, tests/test_torch_sifigan.py, account for it)."""
    root, cfg, ckpt, wavs = assets
    d = str(root / "anasyn")
    _write_wavs(d, wavs)
    args = ["--in-dir", d, "--config", cfg, "--checkpoint-path", ckpt,
            "--anasyn", "--f0-factors", "0.5,1.0,2.0"]
    _run_jax_cli(args)
    # the JAX outputs out of the way (their names keep them out of the
    # port's input list); the inputs' order in the directory is unchanged
    os.makedirs(os.path.join(d, "jax"))
    outs = sorted(f for f in os.listdir(d) if "_anasyn" in f)
    assert len(outs) == 9
    for f in outs:
        shutil.move(os.path.join(d, f), os.path.join(d, "jax", f))
    post.main(args + ["--device", "cpu", "--verbose", "0"])
    assert sorted(f for f in os.listdir(d) if "_anasyn" in f) == outs
    for f in outs:
        want, _ = read_wav(os.path.join(d, "jax", f))
        got, sr = read_wav(os.path.join(d, f))
        assert sr == SR and got.shape == want.shape
        assert np.abs(got - want).max() <= 2e-3, f
        assert np.abs(want).max() > 0.1


def _jax_ssc(d, cfg_dict, ckpt, scaler):
    """The JAX CLI's SSC flow for every wav of ``d`` in its glob order:
    the lf0 h5 interpolated to the analysis frames, ``world_mcep_bap``,
    continuous F0, scaled aux features, then bucket-padded pow2-batched
    synthesis with JAX's generator, edge padding and excitation draws."""
    from serenade_tpu.bin.ssc_postprocessing import convert_continuous_f0
    from serenade_tpu.utils.h5 import read_hdf5

    config = dict(post.DEFAULT_CONFIG, **cfg_dict)
    model = JaxSiFiGAN(in_channels=43, channels=32,
                       filter_resblock_kernel_sizes=(3, 5),
                       filter_resblock_dilations=((1, 3), (1, 3)))
    params = jload(ckpt, model)
    items = []
    for path in glob.glob(os.path.join(d, "**", "*.wav"), recursive=True):
        if "_sifigan" in os.path.basename(path):
            continue
        x, _ = read_wav(path)
        n = 1 + len(x) // HOP
        lf0 = read_hdf5(path.replace(".wav", ".h5"), "lf0").reshape(-1)
        grid = np.linspace(0, len(lf0) - 1, n)
        lf0 = np.maximum(np.interp(grid, np.arange(len(lf0)), lf0), 0.0)
        mcep, bap, _ = jfeat.world_mcep_bap(x, lf0.astype(np.float32), SR,
                                            5.0, 39)
        _, cf0, _ = convert_continuous_f0(lf0)
        c = np.concatenate([scaler["mcep"].transform(mcep),
                            scaler["bap"].transform(bap)], 1)
        items.append((path, c.astype(np.float32), cf0, n))
    gen = jfeat.SignalGenerator(sample_rate=SR, hop_size=HOP, seed=100)
    out = {}
    for t_b in (128, 256):
        group = [it for it in items if -(-it[3] // 128) * 128 == t_b]
        batch = group + [group[-1]] * ((1 << (len(group) - 1).bit_length())
                                       - len(group))
        pads = [t_b - it[3] for it in batch]
        c = np.stack([np.pad(it[1], ((0, p), (0, 0)), mode="edge")
                      for it, p in zip(batch, pads)])
        sine = np.stack([gen(np.pad(it[2], (0, p), mode="edge"))
                         for it, p in zip(batch, pads)])
        rows = [jfeat.dense_factors_per_level(
            np.pad(it[2], (0, p), mode="edge"), SR, config["dense_factors"],
            (5, 4, 3, 2)) for it, p in zip(batch, pads)]
        dfs = [np.stack([r[i] for r in rows]) for i in range(4)]
        y = np.asarray(jax.jit(model.apply)(params, jnp.asarray(sine),
                                            jnp.asarray(c),
                                            [jnp.asarray(a) for a in dfs])[0])
        for row, it in zip(y, group):
            out[it[0]] = row[:it[3] * HOP, 0]
    return out


def test_ssc_cli_matches_jax_flow(assets):
    """SSC mode: each wav's decode-written lf0 (an h5 of another frame
    count, with unvoiced frames) and a ``stats.joblib`` of JAX's aux
    scalers, which the port reads without the JAX package.  Each
    ``*_sifigan.wav`` within 2e-3 of JAX's flow (its PCM16 rounding
    against f32, and the 0.012 of JAX's f32 mel-cepstra)."""
    root, cfg, ckpt, wavs = assets
    d = str(root / "ssc")
    _write_wavs(d, wavs)
    rng = np.random.default_rng(3)
    for name, x in wavs.items():
        lf0 = np.full((len(x) // HOP - 7, 1), 250.0, np.float32)
        lf0[:6] = 0.0
        lf0[40:44] = 0.0
        write_hdf5(os.path.join(d, f"{name}.h5"), "lf0", lf0)
    scaler = {"mcep": StandardScaler().fit(rng.normal(size=(50, 40))),
              "bap": StandardScaler().fit(rng.normal(-10, 4, (50, 3)))}
    stats = str(root / "sifigan_stats.joblib")
    joblib.dump(scaler, stats)
    post.main(["--in-dir", d, "--config", cfg, "--checkpoint-path", ckpt,
               "--stats", stats, "--device", "cpu", "--verbose", "0"])
    want = _jax_ssc(d, CONFIG, ckpt, scaler)
    assert len(want) == 3
    for path, ref in want.items():
        got, _ = read_wav(path.replace(".wav", "_sifigan.wav"))
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 2e-3, path


def test_bucketed_synthesis_differs_only_in_the_tail(assets):
    """``--synth-frame-bucket 128`` against exact lengths (0) with the
    excitation's noise off: within 1e-4 outside the generator's receptive
    field at the utterance's end (0.25 s), as JAX's test holds it."""
    root, cfg_path, ckpt, wavs = assets
    d = str(root / "tail")
    x = sung(1.2, 220.0, 9)
    _write_wavs(d, {"utt_Tenor": x})
    write_hdf5(os.path.join(d, "utt_Tenor.h5"), "lf0",
               np.full((len(x) // HOP, 1), 220.0, np.float32))
    cfg = str(root / "quiet.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump(dict(CONFIG, noise_amp=0.0), f)
    ys = []
    for bucket in ("0", "128"):
        post.main(["--in-dir", d, "--config", cfg, "--checkpoint-path", ckpt,
                   "--f0-backend", "yin", "--synth-frame-bucket", bucket,
                   "--device", "cpu", "--verbose", "0"])
        ys.append(read_wav(os.path.join(d, "utt_Tenor_sifigan.wav"))[0])
    exact, bucketed = ys
    assert exact.shape == bucketed.shape and len(exact) > 2 * 6000
    assert np.abs(exact - bucketed)[:-6000].max() <= 1e-4


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="no g++: the native library cannot build")
def test_native_backends_through_the_cli(assets):
    """``--f0-backend harvest_native --analysis-backend native --anasyn``
    on JAX's CLI and on the port's, the same wav and weights: the host
    analysis is the same C++ on both sides (``native.py`` equals JAX's
    bindings, tests/test_torch_world.py), so each ``*_anasyn.wav`` is
    within 2e-4 of JAX's (the generators' f32 sums and PCM16's step of
    3.1e-5).  Beside it, the port's device path on the same wav: of the
    same length and within 5e-2 (the C++ Harvest decimates by a windowed
    sinc, its CheapTrick sums in f64)."""
    root, cfg, ckpt, wavs = assets
    native = ["--f0-backend", "harvest_native", "--analysis-backend",
              "native"]
    base = ["--config", cfg, "--checkpoint-path", ckpt, "--anasyn"]
    outs = {}
    for kind, extra in (("jax", native), ("native", native), ("device", [])):
        d = str(root / f"cli_{kind}")
        _write_wavs(d, {"utt_c_Alto": wavs["utt_c_Alto"]})
        if kind == "jax":
            _run_jax_cli(["--in-dir", d, *base, *extra])
        else:
            post.main(["--in-dir", d, *base, "--device", "cpu",
                       "--verbose", "0", *extra])
        outs[kind] = read_wav(os.path.join(d, "utt_c_Alto_anasyn.wav"))[0]
    assert outs["native"].shape == outs["jax"].shape == outs["device"].shape
    assert np.abs(outs["jax"]).max() > 0.1
    assert np.abs(outs["native"] - outs["jax"]).max() <= 2e-4
    assert np.abs(outs["native"] - outs["device"]).max() <= 5e-2


@pytest.mark.parametrize("case", ["directory", "missing_ckpt",
                                  "missing_stats", "factors_without_anasyn",
                                  "native_d4c", "no_lf0"])
def test_refusals_by_name(assets, tmp_path, case):
    """An Orbax checkpoint directory of the JAX package (a directory of
    the port's vocoder trainer loads, ``tests/test_torch_vocoder_cli.py``),
    a checkpoint or stats file that does not exist (JAX falls back), F0
    factors outside --anasyn, D4C on the native backend, and an SSC
    utterance without its lf0."""
    root, cfg, ckpt, wavs = assets
    d = str(tmp_path / "in")
    _write_wavs(d, {"utt_a_Tenor": wavs["utt_a_Tenor"]})
    base = ["--in-dir", d, "--config", cfg, "--device", "cpu"]
    if case == "directory":
        (tmp_path / "_CHECKPOINT_METADATA").write_text("")
        with pytest.raises(ValueError, match="Orbax"):
            post.main(base + ["--checkpoint-path", str(tmp_path)])
    elif case == "missing_ckpt":
        with pytest.raises(FileNotFoundError, match="checkpoint"):
            post.main(base + ["--checkpoint-path", str(tmp_path / "x.pkl")])
    elif case == "missing_stats":
        with pytest.raises(FileNotFoundError, match="stats"):
            post.main(base + ["--checkpoint-path", ckpt, "--stats",
                              str(tmp_path / "s.joblib")])
    elif case == "factors_without_anasyn":
        with pytest.raises(SystemExit):
            post.main(base + ["--f0-factors", "2.0"])
    elif case == "native_d4c":
        with pytest.raises(SystemExit):
            post.main(base + ["--analysis-backend", "native",
                              "--ap-backend", "d4c"])
    else:
        model = post.load_generator(CONFIG, ckpt, device="cpu")
        utt = {"key": "u", "wav": wavs["utt_a_Tenor"], "lf0": None,
               "f0_range": (130, 440)}
        with pytest.raises(ValueError, match="no lf0"):
            list(post.postprocess_core(
                model, [utt], dict(post.DEFAULT_CONFIG, **CONFIG),
                device="cpu"))
