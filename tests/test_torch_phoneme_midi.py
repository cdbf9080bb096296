"""The port's phoneme-MIDI transcriber against the JAX package's, on the
CPU.

``modules/phoneme_midi``: the model's frame logits against
``TranscriptionModel.apply`` at a narrow width (20 mels, model_complexity
2 = 32 channels) on the weights of an upstream-layout torch twin (the
one ``tests/test_phoneme_midi.py`` builds, its BatchNorm statistics
randomized), given to JAX through JAX's converter and to the port both
through the param bridge (JAX's folded LSTM biases) and through the
upstream loader (both biases kept); the dB mel frontend; the decoding
(``peak_select``, ``decode_notes``, ``FramewiseDecoder``) on seeded
logits; ``load_transcriber`` on a ``midi_model.pt`` the test writes; and
``bin/preprocess.py --midi-model-ckpt`` against JAX's CLI on one tiny
waveform.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from serenade_tpu.modules.phoneme_midi import decoding as jdec
from serenade_tpu.modules.phoneme_midi.convert import (
    convert_transcription_model,
)
from serenade_tpu.modules.phoneme_midi.model import (
    TranscriptionModel as JaxTranscriber,
    load_transcriber as jax_load_transcriber,
    mel_db_frontend as jax_mel_db,
)
from serenade_tpu.utils import h5 as jh5

from serenade_tpu_torch.bin import preprocess as ppre
from serenade_tpu_torch.convert import state_dict_from_flax
from serenade_tpu_torch.modules.phoneme_midi import decoding as pdec
from serenade_tpu_torch.modules.phoneme_midi.convert import (
    load_upstream_state_dict, to_upstream_state_dict,
)
from serenade_tpu_torch.modules.phoneme_midi.model import (
    TranscriptionModel, load_transcriber, mel_db_frontend,
)
from test_phoneme_midi import MODEL_SIZE, N_MELS, _torch_modules
from test_torch_features import FC, assert_features_agree, sung

# the upstream config's keys at the narrow width
CONFIG = dict(n_mels=N_MELS, model_complexity=MODEL_SIZE // 16,
              sample_rate=16000, win_length=1024, hop_length=160, fmin=30.0,
              fmax=8000.0, onset_threshold=0.5, offset_threshold=0.5,
              pitch_sum="median")
# f32 logits through three BiLSTMs and four conv stacks (JAX's own test
# holds it to its torch twin at 3e-5)
LOGIT_TOL = 3e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _song():
    """Three sung notes (220, 330 and 262 Hz) with rests, at 24 kHz."""
    rest = np.zeros(3600, np.float32)
    return np.concatenate([sung(0.5, 5, 220.0), rest, sung(0.6, 6, 330.0),
                           rest, sung(0.5, 7, 262.0)])


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """The upstream-layout twin with random BatchNorm statistics, its
    output layer scaled and centred on ``_song``'s median logits (so its
    onset, offset and activation tracks cross the decoder's thresholds
    and transcribe notes), its ``midi_model.pt``, JAX's params and JAX's
    logits of a seeded mel (traced once)."""
    from serenade_tpu.utils.audio import resample as jax_resample

    ref = _torch_modules()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in ref.state_dict().items():
            if name.endswith(("running_mean", "bias")):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
        mel_db = jax_mel_db(jax_resample(_song(), 24000, 16000), 16000,
                            CONFIG["win_length"], CONFIG["hop_length"],
                            N_MELS, CONFIG["fmin"], CONFIG["fmax"])
        ref.combined_fc.weight.mul_(20.0)
        logits = ref(torch.from_numpy(np.array(mel_db))[None])[0]
        ref.combined_fc.bias.sub_(logits.median(dim=0).values)
    sd = ref.state_dict()
    path = tmp_path_factory.mktemp("midi") / "midi_model.pt"
    torch.save({"config": CONFIG, "model_state_dict": sd}, str(path))
    params = convert_transcription_model(sd, CONFIG)
    mel = np.random.default_rng(0).normal(size=(2, 40, N_MELS)).astype(
        np.float32)
    jmodel = JaxTranscriber(n_mels=N_MELS, model_size=MODEL_SIZE)
    logits = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(mel)))
    return dict(ref=ref, sd=sd, path=str(path), mel=mel, logits=logits,
                params=jax.tree_util.tree_map(np.asarray, params))


def test_transcriber_logits_match_jax(twin):
    """Through the param bridge (bias_ih the folded sum, bias_hh 0) and
    through the upstream loader (both biases as they were): the logits
    within ``LOGIT_TOL`` of JAX's, and of the twin's own forward; the
    loader's names map back to the upstream state dict exactly."""
    mel = torch.from_numpy(twin["mel"])
    with torch.no_grad():
        expected = twin["ref"](mel).numpy()
    for sd in (state_dict_from_flax(
            TranscriptionModel(N_MELS, MODEL_SIZE), twin["params"]),
            load_upstream_state_dict(twin["sd"])):
        model = TranscriptionModel(N_MELS, MODEL_SIZE)
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = model.eval()(mel).numpy()
        assert got.shape == (2, 40, 3)
        np.testing.assert_allclose(got, twin["logits"], atol=LOGIT_TOL)
        np.testing.assert_allclose(got, expected, atol=LOGIT_TOL)
    bridged = state_dict_from_flax(TranscriptionModel(N_MELS, MODEL_SIZE),
                                   twin["params"])
    assert not bridged["lang_rnn.bias_hh_l0"].any()
    torch.testing.assert_close(
        load_upstream_state_dict(twin["sd"])["lang_rnn.bias_hh_l0"],
        twin["sd"]["lang_rnn.rnn.bias_hh_l0"], rtol=0, atol=0)
    back = to_upstream_state_dict(load_upstream_state_dict(twin["sd"]))
    assert set(back) == set(twin["sd"])
    for k, v in twin["sd"].items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0,
                                   check_dtype=False)


def test_mel_db_frontend_matches_jax():
    """The dB power mel, clamped 80 dB under the input's maximum."""
    audio = sung(0.6, 3, 220.0)[:9600]
    args = (16000, 1024, 160, N_MELS, 30.0, 8000.0)
    got = mel_db_frontend(torch.from_numpy(audio), *args).numpy()
    want = np.asarray(jax_mel_db(audio, *args))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_peak_select_and_decode_notes_match_jax():
    """Seeded onset, offset and activation tracks with an F0 track of
    notes and gaps: every summary mode gives JAX's notes and intervals
    exactly (the same host numpy)."""
    rng = np.random.default_rng(2)
    for threshold in (0.3, 0.5, 0.7):
        p = rng.random(200)
        np.testing.assert_array_equal(pdec.peak_select(p, threshold),
                                      jdec.peak_select(p, threshold))
    n = 300
    onsets = jdec.peak_select(rng.random(n), 0.8)
    offsets = jdec.peak_select(rng.random(n), 0.85)
    frames = rng.random(n)
    f0 = np.where(rng.random(n) > 0.2, 220.0 * 2 ** (
        rng.normal(size=n).cumsum() / 40.0), 0.0)
    for mode in ("median", "weighted_mean", "weighted_median"):
        for kw in ({}, {"offsets": offsets}, {"frames": frames},
                   {"offsets": offsets, "frames": frames}):
            got = pdec.decode_notes(onsets, f0, mode, **kw)
            want = jdec.decode_notes(onsets, f0, mode, **kw)
            assert got == want and len(got[0]) > 3
    with pytest.raises(ValueError, match="pitch_sum"):
        pdec.decode_notes(onsets, f0, "mean")


@pytest.mark.parametrize("f0_mode", ["viterbi", "yin"])
def test_framewise_decoder_matches_jax(f0_mode):
    """Clean logits of three notes over a sung waveform: the same
    intervals as JAX's decoder and pitches within 0.01 semitone, the F0
    estimated from the audio by each side's YIN (+ Viterbi)."""
    sr, hop = 16000, 160
    audio = sung(2.2, 4, 220.0)
    n_frames = len(audio) // hop
    pred = np.full((n_frames, 3), -8.0, np.float32)
    for on, off in ((10, 60), (80, 140), (150, 200)):
        pred[on, 0] = pred[off, 1] = 8.0
        pred[on:off + 1, 2] = 8.0
    cfg = dict(CONFIG, f0_mode=f0_mode)
    got = pdec.FramewiseDecoder(cfg, device="cpu").decode(pred, audio=audio)
    want = jdec.FramewiseDecoder(cfg).decode(pred, audio=audio)
    assert got[1] == want[1] == [(10, 61), (80, 141), (150, 201)]
    np.testing.assert_allclose(got[0], want[0], atol=0.01)
    f0 = np.full(n_frames, 261.63)
    assert pdec.FramewiseDecoder(cfg).decode(pred, f0=f0) == \
        jdec.FramewiseDecoder(cfg).decode(pred, f0=f0)


def test_load_transcriber_matches_jax(twin):
    """``transcribe_fn(audio, fs)`` from the written ``midi_model.pt``
    (read with ``weights_only=True``) against JAX's on ``_song`` at 24
    kHz: the same notes and intervals, several notes."""
    got = load_transcriber(twin["path"], device="cpu")(_song(), 24000)
    want = jax_load_transcriber(twin["path"])(_song(), 24000)
    assert got[0] == want[0] and len(got[0]) > 2
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-9)


def test_preprocess_midi_model_ckpt_matches_jax(twin, tmp_path):
    """``bin/preprocess.py --midi-model-ckpt`` (once refused by name)
    against JAX's CLI on one waveform: the same dump key by key, the
    score (``midi``, ``est_lf0_score``) from the transcriber, which
    differs from the F0 segmentation's."""
    from serenade_tpu.bin.preprocess import main as jax_pre

    path = tmp_path / "u0.wav"
    wavfile.write(str(path), 24000, (_song() * 32767).astype(np.int16))
    scp = tmp_path / "wav.scp"
    scp.write_text(f"u0 {path}\n")
    cfg = tmp_path / "conf.yml"
    cfg.write_text(yaml.safe_dump(FC))
    out = {}
    for side in ("jax", "port", "f0"):
        argv = ["--wav-scp", str(scp), "--dumpdir", str(tmp_path / side),
                "--config", str(cfg), "--allow-missing-hubert", "true",
                "--verbose", "0"]
        if side != "f0":
            argv += ["--midi-model-ckpt", twin["path"]]
        if side == "jax":
            old, sys.argv = sys.argv, ["prog"] + argv
            try:
                jax_pre()
            finally:
                sys.argv = old
        else:
            ppre.main(argv + ["--device", "cpu"])
        out[side] = jh5.read_hdf5_many(str(tmp_path / side / "u0.h5"), (
            "wave", "logmel", "loud", "f0", "vuv", "midi", "est_lf0_score",
            "gt_lf0_score"))
    assert os.listdir(tmp_path / "port") == ["u0.h5"]
    assert_features_agree(out["port"], out["jax"], hubert=False)
    for k in ("midi", "est_lf0_score"):
        np.testing.assert_array_equal(out["port"][k], out["jax"][k])
    assert not np.array_equal(out["port"]["midi"], out["f0"]["midi"])
