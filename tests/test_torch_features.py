"""The port's raw-audio slice: feature extraction and the raw-audio entry
points, against the JAX package on the CPU.

The same seeded numpy waveforms go through ``serenade_tpu``'s functions
and their counterparts in ``serenade_tpu_torch`` (f32, small widths):
the STFT, log-mel and loudness, the device resample, YIN and the Viterbi
trellis, the MIDI helpers, ContentVec through the flax bridge (2 layers,
64 wide) and the Hugging Face loader at full width, ``extract_features``
and ``extract_features_batch``, ``Converter.convert_wav``, and the
batching server's ``/convert_wav``.  Each tolerance is stated where it is
used.  On the CPU the Viterbi trellis runs its plain version (the kernel
is held against it on the card by ``tests/test_torch_cuda.py``).

Run alone: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_features.py -q``.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from serenade_tpu import features as jfeat
from serenade_tpu.ops import f0 as jf0
from serenade_tpu.ops import mel as jmel
from serenade_tpu.ops import midi as jmidi
from serenade_tpu.ops import resample as jres
from serenade_tpu.ops import stft as jstft
from serenade_tpu.models.serenade import Serenade as JaxSerenade
from serenade_tpu.modules import contentvec as jcv
from serenade_tpu.vocoder.hifigan import HiFiGANGenerator as JaxHiFiGAN

from serenade_tpu_torch import features, serving
from serenade_tpu_torch.api import Converter
from serenade_tpu_torch.bin import serve
from serenade_tpu_torch.bin.preprocess import make_content_fn
from serenade_tpu_torch.convert import contentvec_state_dict_from_flax
from serenade_tpu_torch.modules import contentvec as pcv
from serenade_tpu_torch.ops import f0 as pf0
from serenade_tpu_torch.ops import mel as pmel
from serenade_tpu_torch.ops import midi as pmidi
from serenade_tpu_torch.ops import resample as pres
from serenade_tpu_torch.ops import stft as pstft
from serenade_tpu_torch.ops import viterbi_cuda
from test_torch_slice import CFG, STEPS, TEMP, VOC, _jax_side
import torch_parallel_worker as worker

SR = 24000
FC = dict(sampling_rate=SR, fft_size=512, hop_size=240, win_length=480,
          num_mels=80, fmin=63.0, fmax=12000.0, eps=1e-6)
# ContentVec at a narrow width (the conv feature extractor keeps 512)
CV = dict(dim=64, num_layers=2, heads=4, ffn_dim=128)
CFG64 = dict(CFG, input_dim=64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sung(seconds, seed, f0=220.0):
    """A sung-like waveform: a harmonic tone with 5.5 Hz vibrato, a note
    change (a minor third up) halfway, a 50 ms fade at each end and
    breath noise."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * SR))
    t = np.arange(n) / SR
    note = np.where(t < seconds / 2, f0, f0 * 2 ** (3 / 12))
    phase = 2 * np.pi * np.cumsum(note * (1 + 0.015 * np.sin(
        2 * np.pi * 5.5 * t))) / SR
    x = sum(a * np.sin(k * phase)
            for k, a in enumerate((0.3, 0.12, 0.06, 0.03), 1))
    env = np.clip(np.minimum(t, seconds - t) / 0.05, 0, 1)
    return (x * env + 0.01 * rng.normal(size=n)).astype(np.float32)


def signals(seconds=1.5):
    """A plain tone, a vibrato tone, silence and noise, one length."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    rng = np.random.default_rng(3)
    tone = 0.3 * np.sin(2 * np.pi * 330 * t)
    vib = 0.3 * np.sin(2 * np.pi * np.cumsum(
        440 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))) / SR)
    return np.stack([tone, vib, np.zeros(n), 0.1 * rng.normal(size=n)]
                    ).astype(np.float32)


def assert_f0_agrees(f0, vuv, f0_j, vuv_j):
    """vuv equal on at least 99.5 % of frames; f0 within 1e-3 relative
    where both are voiced (an f32 FFT in either framework may move a
    near-tie between candidate dips by a frame)."""
    f0, vuv, f0_j, vuv_j = map(np.asarray, (f0, vuv, f0_j, vuv_j))
    assert (vuv == vuv_j).mean() >= 0.995, (vuv != vuv_j).sum()
    both = (vuv > 0) & (vuv_j > 0)
    if both.any():
        rel = np.abs(f0[both] - f0_j[both]) / f0_j[both]
        assert rel.max() <= 1e-3, rel.max()


def assert_logmel_agrees(got, want):
    """Within 1e-4 absolute wherever the mel is within 70 dB of its
    frame's peak (log10 at least rowmax - 3.5).  Deeper, JAX's own f32
    sums of the DFT-basis products decide (against f64 sums of the same
    operands its error is 4.2e-5 at 70-80 dB under the peak and 9.2e-5 at
    80-100 dB, ``test_log_mel_against_f64_sums_of_jaxs_operands``; the
    port sums in f64); the eps floor of 1e-6 keeps the difference under
    1e-2."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    loud = want >= want.max(axis=-1, keepdims=True) - 3.5
    assert diff[loud].max() <= 1e-4, diff[loud].max()
    assert diff.max() <= 1e-2, diff.max()


# ---------------------------------------------------------------------------
# signal ops
# ---------------------------------------------------------------------------

def test_stft_power_and_logmel_match_jax():
    """|STFT|^2 within 1e-5 of max(1, the frame's peak) and log-mel by
    ``assert_logmel_agrees``, a batch of four rows against JAX row by
    row."""
    x = np.concatenate([signals(0.5), sung(0.5, 1)[None]])
    p = pstft.stft_power(torch.from_numpy(x), 512, 240, 480).numpy()
    lm = pmel.logmelfilterbank(
        torch.from_numpy(x), SR, fft_size=512, hop_size=240, win_length=480,
        num_mels=80, fmin=63, fmax=12000, eps=1e-6).numpy()
    for i, row in enumerate(x):
        p_j = np.asarray(jstft.stft_power(jnp.asarray(row), 512, 240, 480))
        scale = np.maximum(1.0, p_j.max(axis=-1, keepdims=True))
        assert np.abs(p[i] - p_j).max() <= 1e-5 * scale.max()
        assert (np.abs(p[i] - p_j) <= 1e-5 * scale).all()
        assert_logmel_agrees(lm[i], jmel.logmelfilterbank(
            jnp.asarray(row), SR, fft_size=512, hop_size=240,
            win_length=480, num_mels=80, fmin=63, fmax=12000, eps=1e-6))


def test_log_mel_against_f64_sums_of_jaxs_operands():
    """The reference: JAX's f32 operands (windowed frames, DFT basis, mel
    basis) with every product summed in f64.  The port, which sums the
    DFT products so, is within 1e-6 of it in log10 mel wherever the mel
    is within 70 dB of its frame's peak; JAX (XLA's f32 sums) within 1e-4
    there, which the log-mel tolerance of these tests rests on.  Prints
    the largest error by depth under the peak (``pytest -s``) for JAX,
    the port, and the same products summed in f32 by PyTorch."""
    x = np.concatenate([signals(1.5), sung(1.5, 1)[None],
                        sung(1.5, 2, 440.0)[None]])
    kw = dict(fft_size=512, hop_size=240, win_length=480, num_mels=80,
              fmin=63.0, fmax=12000.0, eps=1e-6)
    window, basis = pstft._operands(512, 480, torch.device("cpu"))
    fw = pstft.frame_signal(torch.from_numpy(x), 512, 240) * window
    mel_b = torch.from_numpy(pmel.mel_filterbank(SR, 512, 80, 63.0,
                                                 12000.0))

    def log_mel(re, im, dtype):
        mag = torch.sqrt(re * re + im * im + 1e-30)
        return torch.log10(torch.clamp_min(mag @ mel_b.to(dtype), 1e-6))

    ref = log_mel(*(fw.double() @ basis).chunk(2, -1), torch.float64)
    f32_sums = log_mel(*(fw @ basis.float()).chunk(2, -1), torch.float32)
    got = {"port": pmel.logmelfilterbank(torch.from_numpy(x), SR, **kw),
           "jax": np.stack([np.asarray(jmel.logmelfilterbank(
               jnp.asarray(row), SR, **kw)) for row in x]),
           "f32 sums": f32_sums}
    ref = ref.numpy()
    depth = ref.max(axis=-1, keepdims=True) - ref
    # decades of mel under the frame's peak: 20 dB each
    bands = ((0, 3.5), (3.5, 4), (4, 5), (5, np.inf))
    err = {}
    for name, a in got.items():
        diff = np.abs(np.asarray(a, np.float64) - ref)
        err[name] = [float(diff[(depth >= lo) & (depth < hi)].max())
                     for lo, hi in bands]
        print(f"{name:9s}", "  ".join(
            f"{20 * lo:.0f}-{20 * hi:.0f} dB: {e:.2e}"
            for (lo, hi), e in zip(bands, err[name])))
    assert err["port"][0] <= 1e-6
    assert err["jax"][0] <= 1e-4


def test_loudness_is_per_row_and_matches_jax():
    """Batched loudness against JAX's vmapped rows, within 1e-4: the
    top_db clip takes each row's own max (a quiet row beside a loud one
    keeps its own clip)."""
    x = np.concatenate([signals(0.5), 0.001 * sung(0.5, 2)[None]])
    got = pmel.loudness_extract(torch.from_numpy(x), SR, 240).numpy()
    want = np.asarray(jax.vmap(lambda w: jmel.loudness_extract(w, SR, 240))(
        jnp.asarray(x)))
    assert got.shape == want.shape == (5, 51)
    assert np.abs(got - want).max() <= 1e-4
    alone = pmel.loudness_extract(torch.from_numpy(x[-1:]), SR, 240).numpy()
    np.testing.assert_allclose(got[-1:], alone, rtol=0, atol=1e-6)


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_resample_device_matches_jax_and_scipy(wire):
    """24 -> 16 kHz per row: within 1e-6 of JAX's ``resample_device`` and
    of ``scipy.signal.resample_poly`` (f32 rounding of a 61-tap FIR)."""
    from scipy.signal import resample_poly

    x = np.stack([sung(0.37, 4), signals(0.37)[3]])
    if wire == "int16":
        x = np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)
    got = pres.resample_device(torch.from_numpy(x), 2, 3).numpy()
    want = np.asarray(jres.resample_device(jnp.asarray(x), 2, 3))
    assert got.shape == want.shape == (2, (x.shape[1] * 2 + 2) // 3)
    assert np.abs(got - want).max() <= 1e-6
    ref = x.astype(np.float64) / (32768.0 if wire == "int16" else 1.0)
    for g, r in zip(got, ref):
        assert np.abs(g - resample_poly(r, 2, 3)).max() <= 1e-6


VITERBI = dict(voiced_bias=0.35, transition_octave_cost=6.0,
               switch_cost=0.4, f0_floor=60.0, f0_ceil=1100.0)


@jax.jit
def _jax_candidates(x):
    """JAX's own candidate arrays (``yin_f0_viterbi`` up to the trellis,
    serenade_tpu/ops/f0.py:197-239) for one waveform."""
    cmnd, min_lag, max_lag, energy = jf0._cmnd_matrix(
        x, SR, 60.0, 1100.0, 10.0, None)
    L = cmnd.shape[1]
    taus = jnp.arange(L)
    band = (taus >= min_lag) & (taus < max_lag - 1)
    c_band = jnp.where(band[None, :], cmnd, jnp.inf)
    ym1 = jnp.pad(cmnd[:, :-1], ((0, 0), (1, 0)), constant_values=jnp.inf)
    yp1 = jnp.pad(cmnd[:, 1:], ((0, 0), (0, 1)), constant_values=jnp.inf)
    denom = ym1 - 2.0 * cmnd + yp1
    safe = jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)
    delta = jnp.clip(0.5 * (ym1 - yp1) / safe, -1.0, 1.0)
    interp = jnp.maximum(cmnd - 0.125 * jnp.square(ym1 - yp1) / safe, 0.0)
    is_min = (c_band <= ym1) & (c_band < yp1)
    lag_pen = 0.02 * jnp.log2(jnp.maximum(taus.astype(jnp.float32), 1.0)
                              / float(min_lag))
    score = jnp.where(is_min & band[None, :], interp + lag_pen, jnp.inf)
    neg, tau = jax.lax.top_k(-score, 5)
    t0 = jnp.clip(tau, min_lag, max_lag - 2)
    cand_f0 = SR / jnp.maximum(
        t0.astype(jnp.float32) + jnp.take_along_axis(delta, t0, axis=1), 1.0)
    valid = jnp.isfinite(-neg) & (energy[:, None] > 1e-7)
    return cand_f0, jnp.where(valid, -neg, 1e6)


def test_viterbi_select_states_match_jax():
    """The trellis on JAX's own candidate arrays (a sung waveform and
    noise) and on seeded random ones, batched, plus one row of length 1:
    f0 bit for bit and vuv equal, so the states are identical (the
    candidates' frequencies are distinct and inside the range, so f0 names
    the state)."""
    cands = [tuple(map(np.asarray, _jax_candidates(jnp.asarray(x))))
             for x in (sung(1.2, 5), signals(1.2)[3])]
    rng = np.random.default_rng(6)
    n = cands[0][0].shape[0]
    rand_f0 = rng.uniform(80, 1000, size=(n, 5)).astype(np.float32)
    rand_em = rng.uniform(0, 1, size=(n, 5)).astype(np.float32)
    rand_em[rng.random((n, 5)) < 0.3] = 1e6
    cands.append((rand_f0, rand_em))
    c_f0 = np.stack([c[0] for c in cands])
    c_em = np.stack([c[1] for c in cands])
    f0, vuv = pf0.viterbi_f0_select(torch.from_numpy(c_f0),
                                    torch.from_numpy(c_em), **VITERBI)
    select = jax.jit(lambda f, e: jf0.viterbi_f0_select(f, e, **VITERBI))
    for i in range(len(cands)):
        f0_j, vuv_j = select(jnp.asarray(c_f0[i]), jnp.asarray(c_em[i]))
        np.testing.assert_array_equal(f0[i].numpy(), np.asarray(f0_j))
        np.testing.assert_array_equal(vuv[i].numpy(), np.asarray(vuv_j))
    one_j = jf0.viterbi_f0_select(jnp.asarray(rand_f0[:1]),
                                  jnp.asarray(rand_em[:1]), **VITERBI)
    one = pf0.viterbi_f0_select(torch.from_numpy(rand_f0[:1]),
                                torch.from_numpy(rand_em[:1]), **VITERBI)
    np.testing.assert_array_equal(one[0].numpy(), np.asarray(one_j[0]))
    # the states themselves: ties go to the lowest state, as jnp.argmin
    tie_em = np.zeros((1, 4, 2), np.float32)
    tie_f0 = np.full((1, 4, 2), 200.0, np.float32)
    states = viterbi_cuda.viterbi_states_plain(
        torch.from_numpy(tie_em), torch.log2(torch.from_numpy(tie_f0)),
        voiced_bias=0.35, transition_octave_cost=6.0, switch_cost=0.4)
    assert states.tolist() == [[0, 0, 0, 0]]


@pytest.mark.parametrize("backend", ["viterbi", "yin"])
def test_f0_matches_jax_on_tones_vibrato_silence_noise(backend):
    """``yin_f0_viterbi`` / ``yin_f0`` on four signals at once against JAX
    row by row (``assert_f0_agrees``); silence is all unvoiced."""
    x = signals(1.5)
    port_fn, jax_fn = ((pf0.yin_f0_viterbi, jf0.yin_f0_viterbi)
                       if backend == "viterbi" else (pf0.yin_f0, jf0.yin_f0))
    f0, vuv = port_fn(torch.from_numpy(x), fs=SR, f0_floor=70.0,
                      f0_ceil=1100.0)
    for i, row in enumerate(x):
        f0_j, vuv_j = jax_fn(jnp.asarray(row), fs=SR, f0_floor=70.0,
                             f0_ceil=1100.0)
        assert_f0_agrees(f0[i], vuv[i], f0_j, vuv_j)
    assert vuv[2].sum() == 0 and vuv[0].mean() > 0.9 and vuv[1].mean() > 0.9


def test_smooth_f0_median_matches_jax():
    """Exact: a median of five moves no value."""
    rng = np.random.default_rng(7)
    f0 = np.where(rng.random((3, 200)) < 0.3, 0.0,
                  rng.uniform(100, 400, (3, 200))).astype(np.float32)
    got = pf0.smooth_f0_median(torch.from_numpy(f0)).numpy()
    for g, row in zip(got, f0):
        np.testing.assert_array_equal(g, np.asarray(
            jf0.smooth_f0_median(jnp.asarray(row))))


def test_midi_helpers_match_jax():
    """The host's score helpers: identical to the JAX package's."""
    f0 = np.asarray(pf0.smooth_f0_median(pf0.yin_f0_viterbi(
        torch.from_numpy(sung(2.0, 8)[None]), fs=SR)[0]))[0]
    notes, spans = pmidi.f0_to_note_events(f0)
    assert (notes, spans) == jmidi.f0_to_note_events(f0) and len(notes) >= 2
    np.testing.assert_array_equal(
        pmidi.notes_to_frames(notes, spans, 2.0),
        jmidi.notes_to_frames(notes, spans, 2.0))
    midi = np.array([0, 60, 61.5, 0, 72])
    for log in (False, True):
        np.testing.assert_array_equal(
            pmidi.midi_note_array_to_hz(midi, log),
            jmidi.midi_note_array_to_hz(midi, log))
    seq = [{"note": [60, 62], "note_start": [0.0, 0.3],
            "note_end": [0.3, 0.71]},
           {"note": [64], "note_start": [0.5], "note_end": [0.9]}]
    np.testing.assert_array_equal(pmidi.note_seq_to_frames(seq, 0.01),
                                  jmidi.note_seq_to_frames(seq, 0.01))


def test_unported_backends_and_f0_fluc_are_refused():
    """An unknown F0 backend is refused by name.  The Harvest and native
    backends are no longer refused (the name is older than their port;
    tests/test_torch_world.py holds them against JAX), nor is ``f0_fluc``:
    the batch path's is JAX's function of the port's own F0 track and
    within 2e-3 of JAX's ``f0_fluc`` (their F0 tracks agree by
    ``assert_f0_agrees``)."""
    cfg = features.FeatureConfig.from_dict(FC)
    with pytest.raises(ValueError, match="pyin"):
        features.extract_features("u", sung(0.5, 9), SR, cfg,
                                  f0_backend="pyin", device="cpu")
    items = [("u", sung(0.5, 9), SR, None)]
    got = features.extract_features_batch(items, cfg, with_f0_fluc=True,
                                          device="cpu")["u"]
    want = jfeat.extract_features_batch(
        items, jfeat.FeatureConfig.from_dict(FC), with_f0_fluc=True)["u"]
    lo, hi = jfeat.f0_range_for("u", None)
    np.testing.assert_array_equal(
        got["f0_fluc"][:, 0], jfeat.compute_f0_fluctuation(
            got["f0"][:, 0], hi, cfg.shiftms))
    assert got["f0_fluc"].shape == want["f0_fluc"].shape
    assert np.abs(got["f0_fluc"] - want["f0_fluc"]).max() <= 2e-3


# ---------------------------------------------------------------------------
# ContentVec
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def contentvec(tmp_path_factory):
    """One seeded init of the narrow JAX ContentVecEncoder, once a test
    run."""
    model = jcv.ContentVecEncoder(**CV)
    params = worker.shared(
        tmp_path_factory, "torch_features_contentvec",
        lambda _: jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
            jax.random.key(11), jnp.zeros((1, 16000), jnp.float32))))
    return dict(model=model, params=params)


@pytest.mark.parametrize("chunked", [False, True])
def test_contentvec_matches_jax_through_the_flax_bridge(contentvec, chunked,
                                                         monkeypatch):
    """1 s of audio (two rows, a 2 s bucket's padding included) within
    1e-4 of max(1, |JAX|); also with the convolution windows and the
    attention logits cut into many chunks (as a long request's are)."""
    if chunked:
        from serenade_tpu_torch.ops import conv_f32

        monkeypatch.setattr(conv_f32, "MAX_WINDOW_BYTES", 1 << 20)
        monkeypatch.setattr(pcv, "MAX_LOGIT_BYTES", 1 << 14)
    wav = np.zeros((2, 32000), np.float32)
    wav[0, :16000] = sung(16000 / SR * 1.0, 10)[:16000]
    wav[1, :24000] = signals(1.0)[1][:24000]
    want = np.asarray(jax.jit(contentvec["model"].apply)(
        contentvec["params"], jnp.asarray(wav)))
    model = pcv.load_contentvec_params(pcv.ContentVecEncoder(**CV),
                                       contentvec["params"])
    with torch.no_grad():
        got = model(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 198, 64)
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("naming", ["weight_g", "parametrizations"])
def test_hf_loader_matches_the_flax_bridge_at_full_width(naming):
    """A seeded Hugging Face ``HubertModel`` state dict at 12 x 768 (both
    weight-norm namings): the port's loader gives the same state dict,
    bit for bit, as JAX's ``convert_hf_hubert`` through the flax bridge,
    and it loads into the full-width encoder."""
    hf = pcv.seeded_hf_state_dict(0)
    if naming == "parametrizations":
        pre = "encoder.pos_conv_embed.conv."
        hf[pre + "parametrizations.weight.original0"] = hf.pop(
            pre + "weight_g")
        hf[pre + "parametrizations.weight.original1"] = hf.pop(
            pre + "weight_v")
    ours = pcv.convert_hf_hubert(hf)
    theirs = contentvec_state_dict_from_flax(jcv.convert_hf_hubert(hf))
    assert set(ours) == set(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    model = pcv.ContentVecEncoder()
    model.load_state_dict(ours, strict=True)
    assert sum(p.numel() for p in model.parameters()) == 94_370_816


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def content_fns(contentvec, tmp_path_factory):
    """The narrow ContentVec as JAX's own ``make_content_fn`` (its
    buckets, groups and on-device resample; the encoder and the loader
    swapped for the narrow model and its flax tree) and as the port's."""
    import serenade_tpu.modules.contentvec as jmod

    ckpt = tmp_path_factory.mktemp("cv") / "cv.pt"
    torch.save({}, ckpt)
    mp = pytest.MonkeyPatch()
    mp.setattr(jmod, "ContentVecEncoder", lambda: contentvec["model"])
    mp.setattr(jmod, "convert_hf_hubert", lambda sd: contentvec["params"])
    try:
        from serenade_tpu.bin.preprocess import make_content_fn as jmake

        jax_fn = jmake(str(ckpt))
    finally:
        mp.undo()
    port_fn = make_content_fn(contentvec["params"], config=CV, device="cpu")
    return jax_fn, port_fn


def assert_features_agree(got, want, hubert=True):
    """Key by key: log-mel by ``assert_logmel_agrees``, loudness within
    1e-4, f0 and vuv by ``assert_f0_agrees``, the scores and midi equal
    on the tone signals, ContentVec within 1e-4 of max(1, |JAX|)."""
    assert set(got) == set(want) | ({"hubert"} if hubert else set())
    n = want["logmel"].shape[0]
    for k in want:
        assert np.asarray(got[k]).shape == np.asarray(want[k]).shape, k
    assert_logmel_agrees(got["logmel"], want["logmel"])
    assert np.abs(got["loud"] - np.asarray(want["loud"])).max() <= 1e-4
    assert_f0_agrees(got["f0"], got["vuv"], want["f0"], want["vuv"])
    for k in ("est_lf0_score", "gt_lf0_score", "midi"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    np.testing.assert_array_equal(got["wave"], want["wave"])
    if hubert:
        h, h_j = np.asarray(got["hubert"]), np.asarray(want["hubert"])
        assert h.shape == (n, 64)
        assert np.abs(h - h_j).max() <= 1e-4 * max(1.0, np.abs(h_j).max())


def test_extract_features_matches_jax(content_fns):
    """One utterance at 24 kHz and one at 16 kHz (resampled on the host)
    through ``extract_features`` with ContentVec."""
    jax_fn, port_fn = content_fns
    cfg, jcfg = (features.FeatureConfig.from_dict(FC),
                 jfeat.FeatureConfig.from_dict(FC))
    for wav, sr in ((sung(1.1, 12), SR), (sung(0.9, 13)[::3] * 1.0, 8000)):
        got = features.extract_features("utt", wav, sr, cfg,
                                        content_fn=port_fn, device="cpu")
        want = jfeat.extract_features("utt", wav, sr, jcfg,
                                      content_fn=jax_fn)
        assert_features_agree(got, want)


@pytest.mark.parametrize("wire", ["int16", "float32"])
def test_extract_features_batch_matches_jax(content_fns, wire):
    """Pow2 groups (two utterances in one bucket and range, others
    alone), per-item F0 ranges, a bad waveform and a silent one skipped
    alone (None); on the serving form's int16 wire ContentVec resamples
    24 -> 16 kHz on the device (``batch24``), on the f32 wire the host
    resamples (``batch``)."""
    jax_fn, port_fn = content_fns
    items = [("a", sung(1.0, 14), SR, None),
             ("b", sung(1.1, 15, 330.0), SR, None),
             ("bad", np.full(SR, np.nan, np.float32), SR, None),
             ("c", sung(2.2, 16, 180.0), SR, None),
             ("quiet", np.zeros(SR // 2, np.float32), SR, None)]
    ranges = [(100.0, 800.0), (100.0, 800.0), None, None, None]
    kw = dict(pad_group_pow2=True, wire_dtype=wire, f0_ranges=ranges)
    got = features.extract_features_batch(
        items, features.FeatureConfig.from_dict(FC), content_fn=port_fn,
        device="cpu", **kw)
    want = jfeat.extract_features_batch(
        items, jfeat.FeatureConfig.from_dict(FC), content_fn=jax_fn, **kw)
    assert got["bad"] is None and want["bad"] is None
    assert got["quiet"] is None and want["quiet"] is None
    for k in ("a", "b", "c"):
        assert torch.is_tensor(got[k]["hubert"])   # stays on the device
        assert_features_agree(got[k], want[k])
    # a row of a group is the utterance alone (same padded shapes)
    alone = features.extract_features_batch(
        items[:1], features.FeatureConfig.from_dict(FC), content_fn=port_fn,
        device="cpu", **dict(kw, f0_ranges=ranges[:1]))
    assert_features_agree(alone["a"], got["a"])


def _narrow_scaler(rng):
    return {"hubert": {"mean": rng.normal(size=64) * 0.1,
                       "scale": rng.uniform(0.5, 2, size=64)},
            "score": {"min": 30.0, "max": 90.0},
            "loud": {"min": -80.0, "max": 0.0},
            "logmel": {"mean": rng.normal(size=80) - 3,
                       "scale": rng.uniform(0.5, 2, size=80)}}


def test_convert_wav_matches_jax(contentvec, content_fns):
    """``Converter.convert_wav`` end to end against JAX's extraction
    (``serenade_tpu.features.extract_features`` with the same ContentVec)
    and JAX's ``Serenade.inference`` and HiFiGAN on the same parameters
    and noise: the slice's tolerances, mel within 2e-4 and waveform
    within 1e-4."""
    jax_fn, _ = content_fns
    rng = np.random.default_rng(17)
    sc = _narrow_scaler(rng)
    src_wav, ref_wav = sung(1.3, 18), sung(0.8, 19, 300.0)
    jcfg = jfeat.FeatureConfig.from_dict(FC)
    src, ref = (jfeat.extract_features(n, w, SR, jcfg, content_fn=jax_fn)
                for n, w in (("src", src_wav), ("ref", ref_wav)))
    for f in (src, ref):
        f["score"] = f["est_lf0_score"]
    args = _jax_side(sc, src, ref)
    jmodel = JaxSerenade(**CFG64, dtype=jnp.float32)
    k_init, k_noise = jax.random.split(jax.random.key(20))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda *a: jmodel.init(k_init, *a, rng=k_noise, n_timesteps=1,
                               method="inference"))(*args))
    x0 = np.asarray(jax.random.normal(
        k_noise, (1, args[0].shape[1] + args[4].shape[1], 80)) * TEMP)
    t = src["hubert"].shape[0]
    mel_j = np.asarray(jax.jit(lambda p, *a: jmodel.apply(
        p, *a, rng=k_noise, n_timesteps=STEPS, temperature=TEMP,
        method="inference"))(params, *args))[0, :t]
    jgen = JaxHiFiGAN(**VOC)
    vparams = jax.tree_util.tree_map(np.asarray, jax.jit(jgen.init)(
        jax.random.key(21), jnp.zeros((1, 8, 80))))
    vstats = {"mean": rng.normal(size=80) - 3,
              "scale": rng.uniform(0.5, 2, size=80)}
    c = mel_j * sc["logmel"]["scale"] + sc["logmel"]["mean"]
    c = (c - vstats["mean"]) / vstats["scale"]
    wav_j = np.asarray(jax.jit(jgen.apply)(
        vparams, jnp.asarray(c, jnp.float32)[None]))[0, :, 0]

    conv = Converter(
        dict(CFG64, dtype="float32"), params, sc,
        vocoder_config={"sampling_rate": SR, "generator_params": VOC},
        vocoder_params=vparams, vocoder_stats=vstats,
        contentvec_config=CV, contentvec_params=contentvec["params"],
        n_timesteps=STEPS, temperature=TEMP, device="cpu")
    mel, wav, sr = conv.convert_wav(src_wav, ref_wav, SR, x0=x0)
    assert sr == SR and mel.shape == (t, 80) and wav.shape == (t * 6,)
    np.testing.assert_allclose(mel, mel_j, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(wav, wav_j, rtol=1e-4, atol=1e-4)
    emb = conv.style_embedding(ref_wav, SR)
    assert emb.shape == (CFG["gst_embed_dim"],) and np.isfinite(emb).all()


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def raw_server(contentvec):
    rng = np.random.default_rng(22)
    conv = Converter(
        dict(CFG64, dtype="float32"), None, _narrow_scaler(rng),
        vocoder_config={"sampling_rate": SR, "generator_params": VOC},
        vocoder_stats={"mean": np.zeros(80), "scale": np.ones(80)},
        contentvec_config=CV, contentvec_params=contentvec["params"],
        n_timesteps=1, device="cpu")
    return conv, conv.extract_from_wav(sung(0.7, 23, 260.0), SR, "style")


def test_batching_converter_extracts_a_window_at_once(raw_server,
                                                      monkeypatch):
    """Four concurrent raw requests (two with their own reference, two
    with a registered style) go through one batched extraction of six
    waveforms; a bad waveform is refused at submit and one that yields no
    note faults alone."""
    conv, style = raw_server
    calls = []
    run = conv.extract_from_wav_batch

    def spy(wavs, srs, f0_ranges=None):
        calls.append(len(wavs))
        return run(wavs, srs, f0_ranges=f0_ranges)

    monkeypatch.setattr(conv, "extract_from_wav_batch", spy)
    b = serving.BatchingConverter(conv, max_batch=8, max_wait_ms=500.0)
    try:
        b.register_reference("breathy", style)
        srcs = [sung(0.6 + 0.1 * i, 24 + i) for i in range(4)]
        refs = [(sung(0.5, 30 + i, 300.0), SR) if i < 2 else "breathy"
                for i in range(4)]
        results, errors = [None] * 5, []

        def call(i):
            try:
                if i == 4:   # silence: no note, its extraction fails
                    results[i] = b.convert_wav(np.zeros(SR // 2), SR,
                                               "breathy")
                else:
                    results[i] = b.convert_wav(srcs[i], SR, refs[i],
                                               f0_range=(100.0, 900.0))
            except ValueError as e:
                errors.append((i, e))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert [i for i, _ in errors] == [4], errors
        assert calls == [7], calls
        for i in range(4):
            mel, wav, sr = results[i]
            n = mel.shape[0]
            assert n == int(round((0.6 + 0.1 * i) * 100)) and sr == SR
            assert wav.shape == (n * 6,) and np.isfinite(mel).all()
        assert b.stats["requests"] == 4 and b.stats["errors"] == 1
        assert b.stats["extract_sec"] > 0
        with pytest.raises(ValueError, match="not normalized"):
            b.convert_wav(np.full(100, 3.0), SR, "breathy")
        with pytest.raises(ValueError, match="f0_range"):
            b.convert_wav(srcs[0], SR, "breathy", f0_range=(500.0, 100.0))
    finally:
        b.close()


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_convert_wav_over_http(raw_server, tmp_path):
    """``/convert_wav`` on port 0: a RIFF body with ``?style=`` (and a
    voice type from the F0 table), an npz body with its own reference
    wav, a bad waveform answered 400 alone; the answer is a RIFF wav.
    ``/convert_stream`` answers the same RIFF body with a block stream
    ending in its done marker, and 400 without ``?style=``."""
    from serenade_tpu_torch.utils.audio import read_wav, write_wav

    conv, style = raw_server
    b = serving.BatchingConverter(conv, max_batch=4, max_wait_ms=50.0)
    server = serving.make_server(
        b, port=0, f0_table={"Tenor": {"minf0": 130, "maxf0": 440}})
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        b.register_reference("breathy", style)
        riff = io.BytesIO()
        write_wav(riff, sung(0.8, 40), SR)
        status, ctype, body = _post(
            base, "/convert_wav?style=breathy&voice_type=Tenor",
            riff.getvalue())
        wav, sr = read_wav(io.BytesIO(body))
        assert status == 200 and ctype == "audio/wav"
        assert sr == SR and wav.shape == (80 * 6,)
        status, _, body = _post(base, "/convert_wav", serving.encode_wav_request(
            sung(0.6, 41), SR, (sung(0.5, 42, 300.0), SR),
            f0_range=(100.0, 800.0)))
        assert status == 200 and read_wav(io.BytesIO(body))[0].shape == (
            60 * 6,)
        for path, body, code in (
                ("/convert_wav?style=breathy", serving.encode_wav_request(
                    np.full(SR, np.inf, np.float32), SR, "breathy"), 400),
                ("/convert_wav?style=nope", riff.getvalue(), 400),
                ("/convert_wav?style=breathy&voice_type=Bass",
                 riff.getvalue(), 400),
                ("/convert_stream", riff.getvalue(), 400)):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(base, path, body)
            assert exc.value.code == code, path
        # the stream of the same RIFF body: windowed extraction, the block
        # wire, its done marker
        req = urllib.request.Request(
            base + "/convert_stream?style=breathy&voice_type=Tenor",
            data=riff.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            blocks = list(serving.iter_stream_blocks(r))
        assert len(blocks) == 1 and int(blocks[0]["start"]) == 0
        assert blocks[0]["mel"].shape == (80, 80)
        assert blocks[0]["wav"].shape == (80 * 6,)
        health = json.loads(urllib.request.urlopen(base + "/healthz",
                                                   timeout=10).read())
        assert health["requests"] == 2 and health["extract_sec"] > 0
    finally:
        server.shutdown()
        server.server_close()
        b.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_serve_cli_takes_contentvec_f0_table_and_raw_warmup(
        tmp_path, monkeypatch):
    """``bin/serve.py`` with ``--contentvec-ckpt`` (a ``.pt`` Hugging Face
    state dict, here at the narrow width the test's ContentVec config
    has), ``--f0-table`` (JSON) and ``--warmup-raw``, answering
    ``/convert_wav``; ``--warmup-raw`` alone is refused."""
    from serenade_tpu_torch import configs
    from test_torch_serving import _cli_files

    monkeypatch.setattr(configs, "CONTENTVEC_CONFIG", dict(CV))
    torch.save(pcv.seeded_hf_state_dict(3, **CV), tmp_path / "cv.pt")
    (tmp_path / "f0.json").write_text(json.dumps(
        {"Alto": {"minf0": 196, "maxf0": 700}}))
    rng = np.random.default_rng(25)
    argv = _cli_files(tmp_path, rng) + ["--device", "cpu"]
    model = dict(CFG64, dtype="float32")
    (tmp_path / "model.json").write_text(json.dumps(model))
    np.savez(tmp_path / "stats.npz", **{
        f"{feat}_{stat}": np.asarray(v, np.float32)
        for feat, d in _narrow_scaler(rng).items() for stat, v in d.items()})
    np.savez(tmp_path / "breathy.npz", hubert=rng.normal(size=(64, 64)),
             score=np.full(64, 5.5), loud=np.full(64, -20.0),
             logmel=rng.normal(size=(64, 80)) - 3)
    with pytest.raises(SystemExit, match="needs --contentvec-ckpt"):
        serve.build_app(serve.build_argparser().parse_args(
            argv + ["--warmup-raw", "60:50:2"]))
    args = serve.build_argparser().parse_args(argv + [
        "--contentvec-ckpt", str(tmp_path / "cv.pt"),
        "--f0-table", str(tmp_path / "f0.json"), "--warmup-raw", "60:50:2"])
    server, batching = serve.build_app(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert batching.stats["requests"] == 0   # warm-up left no trace
        status, ctype, _ = _post(
            base, "/convert_wav?voice_type=Alto",
            serving.encode_wav_request(sung(0.7, 43, 300.0), SR, "breathy"))
        assert status == 200 and ctype == "audio/wav"
    finally:
        server.shutdown()
        server.server_close()
        batching.close()
    thread.join(timeout=10)
