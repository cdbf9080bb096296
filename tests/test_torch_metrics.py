"""Objective evaluation of the port against the JAX package, on the CPU.

``ops/sptk.py`` and ``metrics.dtw_path`` (host numpy, copied) exactly;
``ops/world.cheaptrick`` on voiced and unvoiced frames; the analysis of
``metrics.extract_eval_feats`` and ``extract_eval_feats_batch`` (YIN +
Viterbi F0 and CheapTrick at 5 ms frames, mel-cepstra); ``pair_metrics``,
``summarize`` and ``cosine_similarity``; ``bin/evaluate.py`` against the
JAX CLI on the same wav directories, ``style_cos`` from
``tests/test_torch_decode.py``'s tiny experiment; and what is refused by
name.  Waveforms are sung-like tones from a seed, 0.7-1.0 s at 24 kHz
(one length bucket, so JAX compiles one analysis program a batch size).
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from serenade_tpu import checkpoint as jckpt
from serenade_tpu import metrics as jmetrics
from serenade_tpu.bin import evaluate as jevaluate
from serenade_tpu.ops import sptk as jsptk
from serenade_tpu.models.convert_serenade import (
    convert_serenade as jax_convert_serenade,
)
from serenade_tpu.ops.world import _linear_smooth as jax_linear_smooth
from serenade_tpu.ops.world import cheaptrick as jax_cheaptrick

from serenade_tpu_torch import checkpoint as pckpt
from serenade_tpu_torch import metrics
from serenade_tpu_torch.bin import evaluate as pevaluate
from serenade_tpu_torch.convert import state_dict_from_flax
from serenade_tpu_torch.models.serenade import Serenade
from serenade_tpu_torch.ops import sptk
from serenade_tpu_torch.ops.world import _linear_smooth, cheaptrick
from serenade_tpu_torch.utils.audio import write_wav
from test_torch_decode import files  # noqa: F401 (fixture)
from test_torch_features import assert_f0_agrees, sung

SR, HOP = 24000, 120            # 5 ms frames, the evaluation's
# (seconds, f0): the targets of the CLI test, and the analysis tests'
WAVS = ((0.9, 220.0), (1.0, 262.0), (0.8, 330.0))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wavs():
    return [sung(s, seed=i, f0=f) for i, (s, f) in enumerate(WAVS)]


def _shifted(wav, cents):
    """``wav`` resampled so its pitch moves by ``cents`` (and its length
    by the inverse ratio)."""
    ratio = 2.0 ** (cents / 1200.0)
    n = int(len(wav) / ratio)
    return np.interp(np.arange(n) * ratio, np.arange(len(wav)), wav).astype(
        np.float32)


def test_sptk_matches_jax():
    """``sp2mc`` (power and log input), ``freqt`` and ``mc2sp`` equal
    JAX's copy bit for bit: the same numpy operations."""
    rng = np.random.default_rng(0)
    spec = np.exp(rng.normal(size=(3, 513)))
    for log_input, s in ((False, spec), (True, np.log(spec))):
        np.testing.assert_array_equal(
            sptk.sp2mc(s, 24, 0.466, log_input=log_input),
            jsptk.sp2mc(s, 24, 0.466, log_input=log_input))
    c = rng.normal(size=(4, 40))
    np.testing.assert_array_equal(sptk.freqt(c, 30, 0.41),
                                  jsptk.freqt(c, 30, 0.41))
    mc = jsptk.sp2mc(spec, 34, 0.466)
    np.testing.assert_array_equal(sptk.mc2sp(mc, 0.466, 1024),
                                  jsptk.mc2sp(mc, 0.466, 1024))
    assert sptk.ALPHA == jsptk.ALPHA


@pytest.mark.parametrize("band_frac", [0.25, 1.0])
def test_dtw_path_matches_jax(band_frac):
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(70, 5)), rng.normal(size=(90, 5))
    cost = np.linalg.norm(a[:, None] - b[None], axis=-1).astype(np.float32)
    for c in (cost, cost.T, cost[:40, :40]):
        got = metrics.dtw_path(c, band_frac=band_frac)
        want = jmetrics.dtw_path(c, band_frac=band_frac)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_linear_smooth_sums_in_f64():
    """The box filter against JAX's ``_linear_smooth`` run in f64
    (``jax.enable_x64``) on a power spectrum spanning 10 decades: within
    1e-4 relative (the port takes the bin positions in f32), where JAX's
    own f32 running sums are off by more."""
    rng = np.random.default_rng(5)
    power = np.exp(rng.normal(size=(6, 1025)) * 4.0).astype(np.float32)
    width = ((2.0 / 3.0) * np.array([500, 196, 90, 300, 120, 70])
             / (SR / 2048)).astype(np.float32)
    got = _linear_smooth(torch.from_numpy(power),
                         torch.from_numpy(width)).numpy()
    with jax.enable_x64(True):
        exact = np.asarray(jax_linear_smooth(power.astype(np.float64),
                                             width.astype(np.float64)))
    f32 = np.asarray(jax.jit(jax_linear_smooth)(power, width))
    rel = np.abs(got - exact) / exact
    assert rel.max() <= 1e-4, rel.max()
    assert (np.abs(f32 - exact) / exact).max() > 10 * rel.max()


@pytest.mark.parametrize("elim_0th", [False, True])
def test_cheaptrick_matches_jax(elim_0th):
    """Two rows batched (a sung tone with an F0 track that drops to
    unvoiced frames, and noise with no voiced frame) against JAX's
    CheapTrick row by row.  The log envelope within 2e-2 where it is
    within 40 dB of its frame's peak, and within 5e-3 on average within
    60 dB: JAX's f32 running sums of the box filter
    (``test_linear_smooth_sums_in_f64``) err at the quiet bins, and the
    cepstral lifter spreads that error over its neighbours."""
    n = int(0.8 * SR)
    rng = np.random.default_rng(2)
    x = np.stack([sung(0.8, seed=5, f0=196.0),
                  (0.05 * rng.normal(size=n)).astype(np.float32)])
    frames = 1 + n // HOP
    f0 = np.zeros((2, frames), np.float32)
    f0[0] = 196.0 * (1 + 0.015 * np.sin(np.arange(frames) * 0.14))
    f0[0, :20] = 0.0
    f0[0, 90:110] = 0.0
    got = np.log(cheaptrick(torch.from_numpy(x), torch.from_numpy(f0),
                            fs=SR, f0_floor=70.0, elim_0th=elim_0th).numpy())
    fn = jax.jit(jax_cheaptrick, static_argnames=("fs", "f0_floor",
                                                  "elim_0th"))
    for row in range(2):
        want = np.log(np.asarray(fn(x[row], f0[row], fs=SR, f0_floor=70.0,
                                    elim_0th=elim_0th)))
        assert got[row].shape == want.shape == (frames, 1025)
        err = np.abs(got[row] - want)
        peak = want.max(axis=1, keepdims=True)
        near, far = (want >= peak - db / 10 * np.log(10.0)
                     for db in (40.0, 60.0))
        assert near.mean() > 0.05 and far.mean() > 0.5
        assert err[near].max() <= 2e-2, (row, err[near].max())
        assert err[far].mean() <= 5e-3, (row, err[far].mean())


@pytest.fixture(scope="module")
def jax_feats():
    """JAX's analysis of ``WAVS``: solo for the first, batched for all
    (with a corrupt waveform in the batch)."""
    wavs = _wavs()
    solo = jmetrics.extract_eval_feats(wavs[0], SR)
    batch = jmetrics.extract_eval_feats_batch(
        wavs[:2] + [np.full(1000, np.nan, np.float32)] + wavs[2:], SR)
    return wavs, solo, batch


def assert_feats_agree(got, want):
    """F0 by the features tests' rule (``assert_f0_agrees``); the
    mel-cepstrum within 1e-3 on average, 3e-3 at the 99th percentile and
    0.1 at most: a few frames carry the envelope's difference where JAX's
    f32 running sums err (``test_cheaptrick_matches_jax``)."""
    assert got["mcep"].shape == want["mcep"].shape
    assert_f0_agrees(got["f0"], got["vuv"], want["f0"], want["vuv"])
    err = np.abs(got["mcep"] - want["mcep"])
    assert err.mean() <= 1e-3 and np.percentile(err, 99) <= 3e-3 \
        and err.max() <= 0.1, (err.mean(), np.percentile(err, 99), err.max())


def test_extract_eval_feats_matches_jax(jax_feats):
    wavs, solo, _ = jax_feats
    got = metrics.extract_eval_feats(wavs[0], SR, device="cpu")
    assert got["mcep"].shape == (1 + len(wavs[0]) // HOP, 35)
    assert_feats_agree(got, solo)


def test_extract_eval_feats_batch_matches_jax(jax_feats):
    """Three waveforms and a NaN one: the corrupt one gives None on both
    sides, the rest agree with JAX's and with the port's lone analysis."""
    wavs, _, want = jax_feats
    batch = wavs[:2] + [np.full(1000, np.nan, np.float32)] + wavs[2:]
    got = metrics.extract_eval_feats_batch(batch, SR, device="cpu")
    assert got[2] is None and want[2] is None
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert_feats_agree(g, w)
    solo = metrics.extract_eval_feats(wavs[1], SR, device="cpu")
    assert_feats_agree(got[1], solo)


def test_pair_metrics_summarize_cosine_match_jax(jax_feats):
    """The metrics of the port's features against JAX's of JAX's, with
    and without DTW: MCD within 0.02 dB, F0 RMSE within 1 cent, V/UV
    error and frames within a frame's share; ``summarize`` and
    ``cosine_similarity`` equal JAX's on the same inputs;
    ``evaluate_pair`` is ``pair_metrics`` of the two lone analyses."""
    wavs, _, want = jax_feats
    got = metrics.extract_eval_feats_batch(wavs, SR, device="cpu")
    want = want[:2] + want[3:]
    per, jper = {}, {}
    for use_dtw in (True, False):
        for i, j in ((0, 1), (1, 2), (0, 0)):
            m = metrics.pair_metrics(got[i], got[j], use_dtw=use_dtw)
            jm = jmetrics.pair_metrics(want[i], want[j], use_dtw=use_dtw)
            assert abs(m["mcd_db"] - jm["mcd_db"]) <= 0.02, (i, j, m, jm)
            assert abs(m["vuv_error"] - jm["vuv_error"]) <= 0.01
            assert abs(m["frames"] - jm["frames"]) <= 0.01 * jm["frames"]
            if jm["f0_rmse_cents"] is None:
                assert m["f0_rmse_cents"] is None
            else:
                assert abs(m["f0_rmse_cents"] - jm["f0_rmse_cents"]) <= 1.0
            per[f"{use_dtw}{i}{j}"], jper[f"{use_dtw}{i}{j}"] = m, jm
    summary, jsummary = metrics.summarize(per), jmetrics.summarize(jper)
    assert set(summary) == set(jsummary)
    assert abs(summary["mcd_db"] - jsummary["mcd_db"]) <= 0.02
    jper["x"] = dict(jper["True01"], style_cos=0.5, f0_rmse_cents=None)
    assert metrics.summarize(jper) == jmetrics.summarize(jper)
    # evaluate_pair: the two lone analyses and pair_metrics
    assert metrics.evaluate_pair(wavs[0], wavs[1], SR, device="cpu") == \
        metrics.pair_metrics(
            metrics.extract_eval_feats(wavs[0], SR, device="cpu"),
            metrics.extract_eval_feats(wavs[1], SR, device="cpu"))
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=16), rng.normal(size=(4, 4))
    assert metrics.cosine_similarity(a, b) == jmetrics.cosine_similarity(a, b)
    assert metrics.cosine_similarity(a, 0 * a) == 0.0


@pytest.mark.parametrize("case", ["nan", "empty", "harvest"])
def test_refused_by_name(case, tmp_path):
    wav = _wavs()[0]
    if case == "harvest":
        # Harvest runs on the device, against JAX's evaluation with
        # Harvest: vuv equal on every frame and F0 within 1e-5 relative
        # (the Harvest rule of tests/test_torch_world.py), the
        # mel-cepstrum by ``assert_feats_agree``; its F0 is that of
        # ``harvest_f0`` on the bucket.  The host Harvest is refused by
        # name, as JAX's evaluation takes device backends only
        from serenade_tpu_torch.ops.harvest import harvest_f0

        got = metrics.extract_eval_feats(wav, SR, f0_backend="harvest",
                                         device="cpu")
        want = jmetrics.extract_eval_feats(wav, SR, f0_backend="harvest")
        np.testing.assert_array_equal(got["vuv"], want["vuv"])
        assert 0.5 < (want["vuv"] > 0).mean() < 1
        np.testing.assert_allclose(got["f0"], want["f0"], rtol=1e-5, atol=0)
        assert_feats_agree(got, want)
        wav_b, n = metrics._bucketed(wav, 120)
        f0 = harvest_f0(torch.from_numpy(wav_b), fs=SR, f0_floor=70.0,
                        f0_ceil=1100.0, frame_period_ms=5.0)[0].numpy()
        np.testing.assert_array_equal(got["f0"], f0[:n])
        with pytest.raises(ValueError, match="harvest_native"):
            metrics.extract_eval_feats(wav, SR, f0_backend="harvest_native",
                                       device="cpu")
        with pytest.raises(ValueError, match="harvest_native"):
            metrics.extract_eval_feats_batch(
                [wav], SR, f0_backend="harvest_native", device="cpu")
        for d in ("c", "t"):
            (tmp_path / d).mkdir()
            write_wav(str(tmp_path / d / "u.wav"), wav, SR)
        with pytest.raises(SystemExit):
            pevaluate.main(["--converted-dir", str(tmp_path / "c"),
                            "--target-dir", str(tmp_path / "t"),
                            "--f0-backend", "harvest_native",
                            "--device", "cpu"])
        return
    bad = np.zeros(0, np.float32) if case == "empty" else wav.copy()
    if case == "nan":
        bad[100] = np.nan
    with pytest.raises(ValueError, match=case.replace("nan", "non-finite")):
        metrics.extract_eval_feats(bad, SR, device="cpu")


def test_evaluate_cli_matches_jax(files, tmp_path, monkeypatch):  # noqa: F811
    """Both CLIs on one pair of directories: targets ``u<i>.wav``;
    converted ``u<i>_Breathy.wav`` an identical copy, a copy 100 cents
    up, one with noise at -20 dB, and one 60 ms late, ``u0_gt.wav``
    excluded and an unpaired stem skipped.  With ``--expdir`` (the decode
    tests' tiny experiment, its 8 mels) and a one-style ``--ref-dict`` the
    GST's ``style_cos`` joins.  Per utterance: MCD within 0.02 dB, F0
    RMSE within 1 cent, V/UV error within 0.01, style_cos within 1e-5;
    the identical pair scores MCD < 0.05 dB (DTW over f32 distances) and
    V/UV error 0."""
    wavs = _wavs()
    rng = np.random.default_rng(4)
    conv, tgt = tmp_path / "converted", tmp_path / "targets"
    conv.mkdir()
    tgt.mkdir()
    copies = [wavs[0], _shifted(wavs[1], 100.0),
              wavs[2] + 0.1 * np.std(wavs[2]) * rng.normal(
                  size=len(wavs[2])).astype(np.float32),
              np.concatenate([np.zeros(int(0.06 * SR), np.float32), wavs[0]])]
    for i, w in enumerate(copies):
        write_wav(str(conv / f"u{i}_Breathy.wav"), w, SR)
        write_wav(str(tgt / f"u{i}.wav"), wavs[i % len(wavs)], SR)
    write_wav(str(conv / "u0_gt.wav"), wavs[1], SR)
    write_wav(str(conv / "lonely_Breathy.wav"), wavs[1], SR)

    # the reference twin's params as JAX's checkpoint and, through the
    # param bridge, the port's, under one config (8 mels, no vocoder)
    config = {k: v for k, v in files["config"].items() if k != "vocoder"}
    config.update(num_mels=8, model_params=dict(
        config["model_params"], gst_norm_type="frozen_batch"))
    jparams = jax.tree_util.tree_map(
        np.asarray, jax_convert_serenade(files["twin"].state_dict()))
    jexp, pexp = tmp_path / "exp_jax", tmp_path / "exp_port"
    for d in (jexp, pexp):
        d.mkdir()
        (d / "config.yml").write_text(yaml.safe_dump(config))
    jckpt.save_checkpoint(str(jexp), 100, jparams)
    pckpt.save_checkpoint(str(pexp), 100, state_dict_from_flax(
        Serenade(**config["model_params"]), jparams))
    ref = files["dump"] / sorted(os.listdir(files["dump"]))[0]
    ref_dict = tmp_path / "refstyles.json"
    ref_dict.write_text(json.dumps({"Breathy": str(ref)}))
    argv = ["--converted-dir", str(conv), "--target-dir", str(tgt),
            "--stats", files["stats"], "--ref-dict", str(ref_dict)]

    jout, pout = tmp_path / "jax.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["evaluate", *argv, "--expdir",
                                      str(jexp), "--out", str(jout)])
    jevaluate.main()
    pevaluate.main(argv + ["--expdir", str(pexp), "--out", str(pout),
                           "--device", "cpu"])
    want, got = (json.loads(p.read_text()) for p in (jout, pout))
    assert got["skipped"] == want["skipped"] == 1
    assert set(got["per_utterance"]) == set(want["per_utterance"]) == {
        f"u{i}_Breathy" for i in range(4)}
    for stem, w in want["per_utterance"].items():
        g = got["per_utterance"][stem]
        assert abs(g["mcd_db"] - w["mcd_db"]) <= 0.02, (stem, g, w)
        assert abs(g["f0_rmse_cents"] - w["f0_rmse_cents"]) <= 1.0, stem
        assert abs(g["vuv_error"] - w["vuv_error"]) <= 0.01, stem
        assert abs(g["style_cos"] - w["style_cos"]) <= 1e-5, stem
    same = got["per_utterance"]["u0_Breathy"]
    assert same["mcd_db"] < 0.05 and same["vuv_error"] == 0.0
    assert got["per_utterance"]["u2_Breathy"]["mcd_db"] > same["mcd_db"]
    for k, v in want["summary"].items():
        assert abs(got["summary"][k] - v) <= {
            "mcd_db": 0.02, "f0_rmse_cents": 1.0, "vuv_error": 0.01,
            "style_cos": 1e-5, "n_utts": 0}[k], k
