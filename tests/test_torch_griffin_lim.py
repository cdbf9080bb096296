"""The port's Griffin-Lim vocoder against the JAX package's, on the CPU.

``vocoder/griffin_lim.py`` on the cases of ``tests/test_griffin_lim.py``
(a harmonic tone's log-mel, 24 and 32 iterations, two rows of different
peaks), the ``Vocoder`` facade's selection of it (``vocoder_available``,
``load_vocoder``, ``Vocoder.from_files``), and a decode of a tiny
experiment directory whose ``vocoder:`` section names a Griffin-Lim
config, held against JAX's ``GriffinLimSynth`` on the decoded mels.
Both sides sum their f32 DFT products in their own order for 24-32
iterations, so each waveform is held relative to JAX's peak.
"""

import json
import os

import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from serenade_tpu.ops.mel import logmelfilterbank
from serenade_tpu.utils import h5 as jh5
from serenade_tpu.utils import scalers as jscalers
from serenade_tpu.vocoder.griffin_lim import GriffinLimSynth as JaxGL
from serenade_tpu.vocoder.vocoder import Vocoder as JaxVocoder
from serenade_tpu.vocoder.vocoder import (
    load_vocoder as jax_load_vocoder,
    vocoder_available as jax_vocoder_available,
)

from serenade_tpu_torch import checkpoint as pckpt
from serenade_tpu_torch.bin import ssc_decode as pdecode
from serenade_tpu_torch.models.layers import init_params_
from serenade_tpu_torch.models.serenade import Serenade
from serenade_tpu_torch.utils import h5 as ph5
from serenade_tpu_torch.vocoder.griffin_lim import GriffinLimSynth
from serenade_tpu_torch.vocoder.vocoder import (
    Vocoder, generator_from_config, load_vocoder, vocoder_available,
)
from test_torch_decode import MODEL_PARAMS

DECODE_MELS = MODEL_PARAMS["output_dim"]

SR, FFT, HOP, WIN, MELS = 24000, 512, 240, 480, 80
GL_ARGS = (SR, FFT, HOP, WIN, MELS, 63, 12000)
GL_CONFIG = dict(sampling_rate=SR, generator_type="GriffinLim",
                 generator_params=dict(fft_size=FFT, hop_size=HOP,
                                       win_length=WIN, num_mels=MELS,
                                       fmin=63, fmax=12000, n_iter=8))
# |port - JAX| over JAX's peak, per waveform: 1.5e-4 to 3.1e-4 measured
PEAK_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _harmonic(f0=220.0, seconds=1.2):
    t = np.arange(int(seconds * SR)) / SR
    y = sum((0.5 ** k) * np.sin(2 * np.pi * (k + 1) * f0 * t)
            for k in range(6))
    return (0.4 * y / np.max(np.abs(y))).astype(np.float32)


def _mel(audio):
    return np.asarray(logmelfilterbank(
        jnp.asarray(audio), SR, fft_size=FFT, hop_size=HOP, win_length=WIN,
        num_mels=MELS, fmin=63, fmax=12000, eps=1e-6))


def _assert_peak_close(got, want, tol=PEAK_TOL):
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)
    assert (err <= tol).all(), err


@pytest.mark.parametrize("n_iter", [24, 32])
def test_griffin_lim_matches_jax(n_iter):
    """Two rows (a 220 Hz tone and a quieter 330 Hz one, so their peak
    clamps differ): the waveforms within ``PEAK_TOL`` of JAX's peak, at
    most 0.95, and the round trip's log-mel correlated with the input's
    as JAX's test asks (> 0.95)."""
    audio = _harmonic()
    mel = np.stack([_mel(audio), _mel(_harmonic(330.0)) - 0.5])
    want = np.asarray(JaxGL(*GL_ARGS, n_iter=n_iter).apply(
        {}, jnp.asarray(mel)))[..., 0]
    synth = GriffinLimSynth(*GL_ARGS, n_iter=n_iter)
    assert not list(synth.parameters())
    got = synth(torch.from_numpy(mel))
    assert got.shape == (2, mel.shape[1] * HOP, 1)
    got = got[..., 0].numpy()
    _assert_peak_close(got, want)
    assert np.isfinite(got).all() and np.abs(got).max() <= 0.95 + 1e-6
    mel2 = _mel(got[0, :len(audio)])
    n = min(mel.shape[1], mel2.shape[0])
    assert np.corrcoef(mel[0, :n].ravel(), mel2[:n].ravel())[0, 1] > 0.95


def _write_configs(tmp_path, mels=MELS):
    gl_yml = tmp_path / "gl.yml"
    gl_yml.write_text(yaml.safe_dump(dict(GL_CONFIG, generator_params=dict(
        GL_CONFIG["generator_params"], num_mels=mels))))
    hifi_yml = tmp_path / "hifi.yml"
    hifi_yml.write_text(yaml.safe_dump(dict(generator_params=dict(
        channels=32))))
    stats = str(tmp_path / "stats.h5")
    jh5.write_hdf5(stats, "mean", np.linspace(-4, -2, mels).astype(
        np.float32))
    jh5.write_hdf5(stats, "scale", np.linspace(0.5, 2, mels).astype(
        np.float32))
    return gl_yml, hifi_yml, stats


def test_vocoder_available_and_selection_match_jax(tmp_path):
    """The gate and the selection: the same answers as JAX's on the same
    sections, and ``load_vocoder`` builds a Griffin-Lim with the keys
    JAX's reads (no parameters), where it used to refuse."""
    gl_yml, hifi_yml, _ = _write_configs(tmp_path)
    ckpt = tmp_path / "real.pkl"
    ckpt.write_bytes(b"x")
    sections = [dict(checkpoint="none", config=str(gl_yml)),
                dict(config=str(gl_yml)),
                dict(checkpoint="/no/such.pkl", config=str(hifi_yml)),
                dict(checkpoint="/no/such.pkl",
                     config=str(tmp_path / "missing.yml")),
                {}, None, dict(checkpoint=str(ckpt))]
    assert [vocoder_available(s) for s in sections] == [
        jax_vocoder_available(s) for s in sections] == [
        True, True, False, False, False, False, True]

    for cfg in (GL_CONFIG, {"generator_type": "griffin_lim",
                            "generator_params": {"in_channels": 40}}):
        assert load_vocoder("none", cfg) == {}
        got = generator_from_config(cfg)
        want, params = jax_load_vocoder("none", cfg)
        assert isinstance(got, GriffinLimSynth) and params == {}
        assert (got.fft_size, got.hop_size, got.num_mels, got.n_iter,
                got.log_base, got.power) == (
            want.fft_size, want.hop_size, want.num_mels, want.n_iter,
            want.log_base, want.power)


def test_vocoder_facade_griffin_lim_matches_jax(tmp_path):
    """``Vocoder.from_files`` (no checkpoint, a Griffin-Lim config, the
    vocoder's stats.h5) against JAX's ``Vocoder`` on the same files:
    ``decode`` and ``decode_batch`` within ``PEAK_TOL``, the serving tail
    ``decode_batch_device`` its PCM16."""
    gl_yml, _, stats = _write_configs(tmp_path)
    rng = np.random.default_rng(0)
    trg = {"mean": rng.normal(size=MELS).astype(np.float32) - 3,
           "scale": rng.uniform(0.5, 2, MELS).astype(np.float32)}
    port = Vocoder.from_files("none", str(gl_yml), stats, trg_stats=trg,
                              device="cpu")
    jax_voc = JaxVocoder("none", str(gl_yml), stats, trg_stats=trg)
    mel = (_mel(_harmonic(seconds=0.5)) - trg["mean"]) / trg["scale"]
    y, sr = port.decode(mel)
    yj, srj = jax_voc.decode(mel)
    assert sr == srj == SR and y.shape == yj.shape == (mel.shape[0] * HOP,)
    _assert_peak_close(y, yj)
    pair = np.stack([mel, mel[::-1].copy()])
    yb = port.decode_batch(pair)
    _assert_peak_close(yb, jax_voc.decode_batch(pair))
    np.testing.assert_array_equal(yb[0], y)
    pcm = port.decode_batch_device(torch.from_numpy(pair),
                                   [mel.shape[0]] * 2).numpy()
    want = np.round(np.clip(yb, -1, 1) * 32767.0)
    assert pcm.dtype == np.int16 and np.abs(pcm - want).max() <= 1


def test_vocoder_facade_missing_stats_fails_loudly(tmp_path):
    gl_yml, _, _ = _write_configs(tmp_path)
    with pytest.raises(FileNotFoundError, match="vocoder stats"):
        Vocoder.from_files("none", str(gl_yml), str(tmp_path / "nope.h5"),
                           trg_stats={"mean": np.zeros(MELS, np.float32),
                                      "scale": np.ones(MELS, np.float32)},
                           device="cpu")


def test_decode_of_a_griffin_lim_expdir(tmp_path):
    """A full-budget-style experiment directory (a port checkpoint, its
    config's ``vocoder:`` section naming a Griffin-Lim config and no
    checkpoint; the small model's 8 mels): the decode CLI writes wavs, and each is JAX's
    ``GriffinLimSynth`` of the same decode's mel (the run with no
    vocoder), normalized as the facade does, within ``PEAK_TOL`` plus
    one PCM16 step."""
    rng = np.random.default_rng(1)
    dump = tmp_path / "dump"
    utts = (("EN_s1_song0_Breathy_Group_0", 60),
            ("EN_s1_song1_Falsetto_Group_0", 50))
    scaler = {"hubert": jscalers.StandardScaler(),
              "logmel": jscalers.StandardScaler(),
              "score": jscalers.MinMaxScaler(),
              "loud": jscalers.MinMaxScaler()}
    for utt, t in utts:
        h5 = str(dump / f"{utt}.h5")
        feats = {"wave": (rng.normal(size=t * HOP) * 0.1).astype(np.float32),
                 "hubert": rng.normal(size=(t, MODEL_PARAMS["input_dim"])),
                 "logmel": rng.normal(size=(t, DECODE_MELS)) - 3,
                 "loud": rng.uniform(-60, 0, (t, 1)),
                 "est_lf0_score": rng.uniform(40, 80, (t, 1)),
                 "f0": rng.uniform(150, 300, (t, 1))}
        for k, v in feats.items():
            jh5.write_hdf5(h5, k, np.asarray(v, np.float32))
        for feat, key in (("hubert", "hubert"), ("logmel", "logmel"),
                          ("score", "est_lf0_score"), ("loud", "loud")):
            scaler[feat].partial_fit(feats[key])
    stats = str(tmp_path / "stats.joblib")
    joblib.dump(scaler, stats)
    gl_yml, _, voc_stats = _write_configs(tmp_path, DECODE_MELS)
    exp = tmp_path / "exp"
    model = init_params_(Serenade(**MODEL_PARAMS), 0)
    pckpt.save_checkpoint(str(exp), 100, model.state_dict())
    config = {"sampling_rate": SR, "model_type": "Serenade",
              "model_params": MODEL_PARAMS, "inference_n_timesteps": 2,
              "vocoder": {"config": str(gl_yml), "stats": voc_stats}}
    (exp / "config.yml").write_text(yaml.safe_dump(config))
    novoc = tmp_path / "config_novoc.yml"
    novoc.write_text(yaml.safe_dump(
        {k: v for k, v in config.items() if k != "vocoder"}))
    styles = tmp_path / "styles.json"
    styles.write_text(json.dumps({"Falsetto": str(dump / f"{utts[1][0]}.h5")}))
    outs = {}
    for side, extra in (("gl", []), ("mel", ["--config", str(novoc)])):
        outs[side] = str(tmp_path / side)
        pdecode.main(["--dumpdir", str(dump), "--stats", stats, "--outdir",
                      outs[side], "--checkpoint",
                      str(exp / "checkpoint-100steps"), "--temperature", "0",
                      "--ref-dict", str(styles), "--device", "cpu"] + extra)
    name = f"{utts[0][0]}_Falsetto"
    mel = ph5.read_hdf5(os.path.join(outs["mel"], f"{name}.h5"), "mel")
    assert not ph5.hdf5_has(os.path.join(outs["gl"], f"{name}.h5"), "mel")
    sr, pcm = wavfile.read(os.path.join(outs["gl"], f"{name}.wav"))
    trg = scaler["logmel"]
    c = mel * trg.scale_ + trg.mean_
    c = (c - jh5.read_hdf5(voc_stats, "mean")) / jh5.read_hdf5(voc_stats,
                                                                "scale")
    want = np.asarray(JaxGL(SR, FFT, HOP, WIN, DECODE_MELS, 63, 12000,
                            n_iter=8).apply(
        {}, jnp.asarray(c[None], jnp.float32)))[0, :, 0] * 32767.0
    assert sr == SR and pcm.shape == want.shape == (mel.shape[0] * HOP,)
    assert np.abs(pcm - want).max() <= PEAK_TOL * np.abs(want).max() + 1
