"""WORLD analysis, Harvest and the native host library of the port against
the JAX package, on the CPU.

Band aperiodicity, ``aperiodicity_spectrum`` and D4C (``ops/world.py``),
Harvest (``ops/harvest.py``, its trellis at 17 states through the
Viterbi wrapper's CPU route), ``utils/signal.world_extract``,
``ops/world_synth.py`` and the low-cut filter against their JAX
counterparts on seeded harmonic tones at 24 kHz; the Viterbi wrapper's
shape checks; ``native.py`` against the device path where ``g++``
builds it.  Each tolerance is stated where it is held.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serenade_tpu.ops import f0 as jf0
from serenade_tpu.ops import harvest as jharvest
from serenade_tpu.ops import world as jworld
from serenade_tpu.ops import world_synth as jsynth
from serenade_tpu.utils import audio as jaudio
from serenade_tpu.utils import signal as jsignal

from serenade_tpu_torch.ops import f0 as pf0
from serenade_tpu_torch.ops import harvest as pharvest
from serenade_tpu_torch.ops import viterbi_cuda
from serenade_tpu_torch.ops import world as pworld
from serenade_tpu_torch.ops import world_synth as psynth
from serenade_tpu_torch.utils import audio as paudio
from serenade_tpu_torch.utils import signal as psignal

SR = 24000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def tone(seconds, f0, seed, noise=0.02, harmonics=8, vibrato=0.02):
    """A harmonic tone with vibrato and white noise, from a seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    phase = 2 * np.pi * np.cumsum(
        f0 * (1 + vibrato * np.sin(2 * np.pi * 5.0 * t))) / SR
    x = sum((0.5 / h) * np.sin(h * phase) for h in range(1, harmonics + 1))
    return (x + noise * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def analysed():
    """Two tones (the first opening with 0.1 s of silence) and JAX's YIN
    F0 of each at 5 ms frames."""
    xs = [tone(0.6, 220.0, 0), tone(0.6, 440.0, 1, noise=0.05)]
    xs[0][:2400] = 0.0
    f0s = [np.asarray(jf0.yin_f0(jnp.asarray(x), fs=SR,
                                 frame_period_ms=5.0)[0]) for x in xs]
    assert all((f0 > 0).mean() > 0.5 for f0 in f0s)
    return np.stack(xs), np.stack(f0s)


def test_band_aperiodicity_matches_jax(analysed):
    """Both rows batched against JAX row by row, in f64
    (``jax.enable_x64``) within 2e-3 dB (measured 1.1e-3: the port's
    FFTs and phases are f32, its band sums and ratios f64) and in f32
    within 1e-2 dB
    (JAX's f32 band sums are up to 3.3e-3 dB from its own f64 result at
    the most periodic frames, where 1 - r is near 1e-3); a row alone
    equal to its batched result; unvoiced frames 0 dB."""
    xs, f0s = analysed
    got = pworld.band_aperiodicity(_t(xs), _t(f0s), fs=SR).numpy()
    for row in range(2):
        want = np.asarray(jworld.band_aperiodicity(
            jnp.asarray(xs[row]), jnp.asarray(f0s[row]), fs=SR))
        with jax.enable_x64(True):
            want64 = np.asarray(jworld.band_aperiodicity(
                jnp.asarray(xs[row], jnp.float64),
                jnp.asarray(f0s[row], jnp.float64), fs=SR))
        assert got[row].shape == want.shape == (f0s.shape[1], 3)
        np.testing.assert_allclose(got[row], want64, atol=2e-3, rtol=0)
        np.testing.assert_allclose(got[row], want, atol=1e-2, rtol=0)
        assert want.min() < -10.0
    alone = pworld.band_aperiodicity(_t(xs[0]), _t(f0s[0]), fs=SR).numpy()
    np.testing.assert_array_equal(alone, got[0])
    assert np.all(got[f0s <= 0] == 0.0)


def test_aperiodicity_spectrum_matches_jax(analysed):
    """The host interpolation as one product with its weights: within
    1e-12 of JAX's per-frame ``np.interp`` (f64 rounding)."""
    xs, f0s = analysed
    bap = np.asarray(jworld.band_aperiodicity(jnp.asarray(xs[0]),
                                              jnp.asarray(f0s[0]), fs=SR))
    want = jworld.aperiodicity_spectrum(bap, SR, 2048)
    got = pworld.aperiodicity_spectrum(bap, SR, 2048)
    assert got.shape == want.shape == (len(bap), 1025)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("row", [0, 1])
def test_d4c_matches_jax_f64(analysed, row):
    """D4C against JAX's D4C computed in f64 (``jax.enable_x64``): within
    1e-3 dB (measured 1e-4).  Against JAX in f32 within 0.1 dB: JAX's own
    f32 result is 0.069 dB from its f64 one on these tones, from the f32
    running sums of its box filters and sorted cumulative sums (ROADMAP
    Queue C, "Not port faults"); the port sums those in f64."""
    xs, f0s = analysed
    got = pworld.d4c(_t(xs), _t(f0s), fs=SR).numpy()[row]
    with jax.enable_x64(True):
        want64 = np.asarray(jworld.d4c(jnp.asarray(xs[row], jnp.float64),
                                       jnp.asarray(f0s[row], jnp.float64),
                                       fs=SR))
    want32 = np.asarray(jworld.d4c(jnp.asarray(xs[row]),
                                   jnp.asarray(f0s[row]), fs=SR))
    assert got.shape == want32.shape == (f0s.shape[1], 3)
    np.testing.assert_allclose(got, want64, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got, want32, atol=0.1, rtol=0)
    assert got.min() < -1.0 and np.all(got[f0s[row] <= 0] == 0.0)


def test_d4c_refuses_frames_past_the_waveform():
    x = tone(0.2, 220.0, 2)
    f0 = np.full(len(x) // 120 + 3, 220.0, np.float32)
    with pytest.raises(ValueError, match="exceed"):
        pworld.d4c(_t(x), _t(f0), fs=SR)


# -- Harvest ----------------------------------------------------------------

FLOOR, CEIL = 80.0, 800.0
HN = SR                                     # 1 s rows, one batch


def _harmonic(f0_traj, amps, noise=0.0, seed=7):
    phase = 2 * np.pi * np.cumsum(f0_traj) / SR
    x = sum(a * np.sin((h + 1) * phase) for h, a in enumerate(amps))
    if noise:
        x = x + np.random.default_rng(seed).normal(0.0, noise, HN)
    return x.astype(np.float32)


_ht = np.arange(HN) / SR
HARVEST_CASES = {
    "vibrato": _harmonic(220.0 * (1 + 0.03 * np.sin(2 * np.pi * 5.5 * _ht)),
                         [0.6 / h for h in range(1, 7)]),
    "glide": _harmonic(196.0 * 2 ** _ht, [0.6 / h for h in range(1, 7)]),
    "high": _harmonic(523.25 * (1 + 0.02 * np.sin(2 * np.pi * 6.0 * _ht)),
                      [0.6 / h for h in range(1, 5)]),
    "breathy": _harmonic(np.full(HN, 330.0), [0.25, 0.35, 0.2, 0.1],
                         noise=0.03),
    "silence": np.zeros(HN, np.float32),
    "noise": np.random.default_rng(8).normal(0.0, 0.1, HN).astype(
        np.float32),
}


@pytest.fixture(scope="module")
def harvest_pair():
    """(JAX, port) Harvest of every case at 5 ms frames, one batch each
    (JAX vmaps; the port takes the batch)."""
    batch = np.stack(list(HARVEST_CASES.values()))
    jf, jv = jax.vmap(lambda a: jharvest.harvest_f0(
        a, fs=SR, f0_floor=FLOOR, f0_ceil=CEIL, frame_period_ms=5.0))(
        jnp.asarray(batch))
    pf, pv = pharvest.harvest_f0(_t(batch), fs=SR, f0_floor=FLOOR,
                                 f0_ceil=CEIL, frame_period_ms=5.0)
    return {name: ((np.asarray(jf[i]), np.asarray(jv[i])),
                   (pf[i].numpy(), pv[i].numpy()))
            for i, name in enumerate(HARVEST_CASES)}


@pytest.mark.parametrize("name", list(HARVEST_CASES))
def test_harvest_matches_jax(harvest_pair, name):
    """V/UV on every frame equal to JAX's, and F0 on voiced frames within
    1e-5 relative (measured 3.6e-7: the channel runs' means sum in f64
    here, in f32 in JAX's scan, 1 ulp apart; the rest is f32 rounding).
    The tones are mostly voiced, silence and noise unvoiced."""
    (jf, jv), (pf, pv) = harvest_pair[name]
    assert pf.shape == jf.shape == (1 + HN // 120,)
    assert np.array_equal(pv, jv), np.flatnonzero(pv != jv)
    voiced = jv > 0
    if name in ("silence", "noise"):
        assert voiced.mean() < 0.1
    else:
        assert voiced.mean() > 0.8
        rel = np.abs(pf[voiced] - jf[voiced]) / jf[voiced]
        assert rel.max() <= 1e-5, rel.max()
    assert np.all(pf[~voiced] == 0.0)


def test_merge_channel_runs_matches_jax():
    """Runs of valid channels into 16 slots, against JAX's scan: the same
    slots filled, each mean within 2e-7 relative (f64 sums rounded once
    against JAX's running f32 sum)."""
    rng = np.random.default_rng(1)
    cand = rng.uniform(80, 800, (60, 40)).astype(np.float32)
    cand[rng.random(cand.shape) < 0.45] = 0.0
    want = np.asarray(jharvest._merge_channel_runs(jnp.asarray(cand), 16))
    got = pharvest._merge_channel_runs(_t(cand), 16).numpy()
    assert got.shape == want.shape == (40, 16)
    assert np.array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


@pytest.mark.parametrize("k", [16, 31])
def test_viterbi_select_at_harvest_width_matches_jax(k):
    """The trellis at Harvest's K = 16 (17 states) and the kernel's widest
    K = 31 through the wrapper's CPU route against JAX's
    ``viterbi_f0_select``: the same f0 and vuv on every frame."""
    rng = np.random.default_rng(k)
    cand = rng.uniform(80.0, 800.0, (300, k)).astype(np.float32)
    em = rng.uniform(0.0, 1.0, (300, k)).astype(np.float32)
    em[rng.random(em.shape) < 0.5] = 4e6
    kw = dict(voiced_bias=0.12, transition_octave_cost=6.0,
              switch_cost=0.4, f0_floor=80.0, f0_ceil=800.0)
    jf, jv = jf0.viterbi_f0_select(jnp.asarray(cand), jnp.asarray(em), **kw)
    pf, pv = pf0.viterbi_f0_select(_t(cand), _t(em), **kw)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("shape,lf_shape,match", [
    ((2, 10, 32), (2, 10, 32), "1 <= K <= 31"),
    ((2, 10, 0), (2, 10, 0), "1 <= K <= 31"),
    ((2, 0, 5), (2, 0, 5), "N >= 1"),
    ((2, 10, 16), (2, 10, 15), "log_f0"),
    ((10, 16), (10, 16), "not \\(B, N, K\\)"),
])
def test_viterbi_wrapper_shape_checks(shape, lf_shape, match):
    """The wrapper refuses on the CPU what the kernel refuses on the card:
    more than 31 candidates (one lane a state), none, no frame, log
    frequencies of another shape, and emissions that are not (B, N, K)."""
    kw = dict(voiced_bias=0.12, transition_octave_cost=6.0, switch_cost=0.4)
    with pytest.raises(ValueError, match=match):
        viterbi_cuda.viterbi_states(torch.zeros(shape), torch.zeros(lf_shape),
                                    **kw)


# -- signal helpers and synthesis ------------------------------------------


def test_low_cut_filter_matches_jax():
    x = tone(0.3, 110.0, 3)
    np.testing.assert_array_equal(paudio.low_cut_filter(x, SR),
                                  jaudio.low_cut_filter(x, SR))


@pytest.fixture(scope="module")
def extracted():
    x = tone(0.8, 262.0, 4, noise=0.01)
    x[:1200] = 0.0
    return (x, jsignal.world_extract(x, SR),
            psignal.world_extract(x, SR, device="cpu"))


def test_world_extract_matches_jax(extracted):
    """vuv equal to JAX's and f0 within 1e-5 relative (YIN in f32, the
    CMND's sums in another order); the aperiodicity spectrum within 2e-4
    (linear, from band aperiodicity within 1e-2 dB); the log envelope
    within 1e-3 of JAX's CheapTrick in f64 (``jax.enable_x64``) on the
    same F0 within 60 dB of each frame's peak (measured 8.5e-6), and
    within 5e-2 of JAX's f32 result within 40 dB: JAX's f32 box-filter
    sums put it up to 0.034 from its own f64 result on this tone (ROADMAP
    Queue C, "Not port faults").  The silent opening's envelope
    underflows to 0 in JAX's f32 and stays under 1e-30 here."""
    x, (jf0_, jsp, jap, jvuv), (pf0_, psp, pap, pvuv) = extracted
    np.testing.assert_array_equal(pvuv, jvuv)
    np.testing.assert_allclose(pf0_, jf0_, rtol=1e-5, atol=0)
    assert psp.shape == jsp.shape and pap.shape == jap.shape
    np.testing.assert_allclose(pap, jap, atol=2e-4, rtol=0)
    live = jsp.min(axis=1) > 0
    assert live.mean() > 0.8 and psp[~live].max() < 1e-30
    with jax.enable_x64(True):
        j64 = np.asarray(jworld.cheaptrick(jnp.asarray(x, jnp.float64),
                                           jnp.asarray(pf0_, jnp.float64),
                                           fs=SR))
    got = np.log(psp[live])
    for want, db, tol in ((np.log(j64[live]), 60.0, 1e-3),
                          (np.log(jsp[live]), 40.0, 5e-2)):
        near = want >= want.max(axis=1, keepdims=True) - db / 10 * np.log(10)
        assert np.abs(got - want)[near].max() <= tol


def test_world_synthesize_and_anasyn_match_jax(extracted):
    """``world_synthesize`` is JAX's host numpy: equal on JAX's analysis.
    ``anasyn`` (the port's analysis, then the same synthesis and noise
    draws) within 1e-3 of the waveform's peak of JAX's."""
    x, (jf0_, jsp, jap, _), _ = extracted
    want = jsynth.world_synthesize(jf0_, jsp, jap, SR, 5.0)
    np.testing.assert_array_equal(
        psynth.world_synthesize(jf0_, jsp, jap, SR, 5.0), want)
    got = psynth.anasyn(x, SR, device="cpu")
    ref = jsynth.anasyn(x, SR)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


# -- the native host library -------------------------------------------------

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++: the native library cannot "
                                      "build")


@pytest.fixture(scope="module")
def native():
    from serenade_tpu_torch import native as mod

    mod.library()
    return mod


@needs_gxx
def test_native_harvest_and_freqt_match_the_device_path(native):
    """``harvest_f0_native`` against the port's Harvest as JAX's
    tests/test_native.py holds it against JAX's (the C++ decimates with a
    windowed sinc): V/UV on 90 % of frames, F0 within 2 cents median and
    20 cents at most on frames both call voiced, the leading silence
    unvoiced; ``freqt_native`` within 1e-10 of ``ops/sptk.freqt``."""
    from serenade_tpu_torch.ops.sptk import freqt

    x = HARVEST_CASES["vibrato"].copy()
    x[:2400] = 0.0
    f0_n, vuv_n = native.harvest_f0_native(x, fs=SR, f0_floor=FLOOR,
                                           f0_ceil=CEIL)
    f0_p, vuv_p = (a.numpy() for a in pharvest.harvest_f0(
        _t(x), fs=SR, f0_floor=FLOOR, f0_ceil=CEIL))
    assert ((vuv_n > 0) == (vuv_p > 0)).mean() > 0.9
    both = (vuv_n > 0) & (vuv_p > 0)
    cents = 1200.0 * np.abs(np.log2(f0_n[both] / f0_p[both]))
    assert both.sum() >= 50 and np.median(cents) < 2.0 and cents.max() < 20.0
    assert vuv_n[:8].sum() == 0
    c = np.random.default_rng(0).normal(size=(7, 65))
    np.testing.assert_allclose(native.freqt_native(c, 24, 0.466),
                               freqt(c, 24, 0.466), rtol=1e-10)


@needs_gxx
def test_native_cheaptrick_and_bandap_match_the_device_path(native, analysed):
    """CheapTrick by tests/test_native.py's rule (log-spectral distance of
    spectra floored 40 dB under each frame's peak: median under 0.1 dB,
    max under 0.5) on the tone without silence, band aperiodicity within
    0.25 dB and 0 dB where unvoiced on the one with; a track longer than
    the audio is refused."""
    xs, f0s = analysed
    sp_p = pworld.cheaptrick(_t(xs[1]), _t(f0s[1]), fs=SR).numpy()
    sp_n = native.cheaptrick_native(xs[1], f0s[1], fs=SR)
    floor = sp_p.max(axis=1, keepdims=True) * 1e-4
    lsd = np.sqrt(np.mean((10 * np.log10(np.maximum(sp_n, floor))
                           - 10 * np.log10(np.maximum(sp_p, floor))) ** 2,
                          axis=1))
    assert np.median(lsd) < 0.1 and lsd.max() < 0.5
    x, f0 = xs[0], f0s[0]                  # opens with silence
    bap_n = native.band_aperiodicity_native(x, f0, fs=SR)
    bap_p = pworld.band_aperiodicity(_t(x), _t(f0), fs=SR).numpy()
    np.testing.assert_allclose(bap_n, bap_p, atol=0.25)
    assert np.all(bap_n[f0 <= 0] == 0.0)
    with pytest.raises(RuntimeError):
        native.cheaptrick_native(x[:2400], f0, fs=SR)


@needs_gxx
@pytest.mark.parametrize("binding", ["yin_f0_native", "harvest_f0_native",
                                     "cheaptrick_native",
                                     "band_aperiodicity_native",
                                     "freqt_native"])
def test_native_bindings_match_jax(native, analysed, binding):
    """Each binding against JAX's (``serenade_tpu.native``) on the same
    inputs: both call the same C++ source, so outputs of the same shape
    and dtype within 1e-6 relative (measured equal), vuv equal.  A wrong
    argument type, order or band count shows here."""
    from serenade_tpu import native as jnative

    xs, f0s = analysed
    x, f0 = xs[0], f0s[0]                  # opens with silence
    if binding == "freqt_native":
        c = np.random.default_rng(1).normal(size=(7, 65))
        args, kw = (c, 24, 0.466), {}
    elif binding in ("cheaptrick_native", "band_aperiodicity_native"):
        args, kw = (x, f0), dict(fs=SR)
    else:
        args, kw = (x,), dict(fs=SR, f0_floor=FLOOR, f0_ceil=CEIL,
                              frame_period_ms=5.0)
    got = getattr(native, binding)(*args, **kw)
    want = getattr(jnative, binding)(*args, **kw)
    got, want = ((got,), (want,)) if isinstance(got, np.ndarray) else \
        (got, want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    if binding in ("yin_f0_native", "harvest_f0_native"):
        np.testing.assert_array_equal(got[1], want[1])
        assert 0 < (got[1] > 0).mean() < 1


def test_native_build_names_its_cause(monkeypatch, tmp_path):
    """No fallback: a compiler that cannot run is an error naming it."""
    from serenade_tpu_torch import native as mod

    monkeypatch.setenv("SERENADE_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        mod.build()


@pytest.mark.parametrize("backend", ["harvest", "native", "harvest_native"])
def test_feature_extraction_f0_backends_match_jax(backend):
    """``features.extract_signal_features_group`` with Harvest on the
    device and with YIN and Harvest on the host (``native.py``): two
    bucketed tones of one group against JAX's, vuv equal and f0 within
    1e-5 relative (Harvest's rule above; the host backends are the same
    C++ in both, so equal), log-mel within 1e-4."""
    if backend != "harvest" and shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot build")
    from serenade_tpu import features as jfeat

    from serenade_tpu_torch import features as pfeat

    waves = [pfeat._bucketed(tone(1.0, f0, 20 + i, vibrato=0.01), 240)[0]
             for i, f0 in enumerate((196.0, 311.0))]
    want = jfeat.extract_signal_features_group(
        waves, jfeat.FeatureConfig(), 80.0, 800.0, backend)
    got = pfeat.extract_signal_features_group(
        waves, pfeat.FeatureConfig(), 80.0, 800.0, backend, device="cpu")
    for g, w in zip(got, want):
        w = {k: np.asarray(v) for k, v in w.items()}
        assert g["f0"].shape == w["f0"].shape
        np.testing.assert_array_equal(g["f0"] > 0, w["f0"] > 0)
        assert (w["f0"] > 0).mean() > 0.5
        np.testing.assert_allclose(g["f0"], w["f0"], rtol=1e-5, atol=0)
        np.testing.assert_allclose(g["logmel"], w["logmel"], atol=1e-4)
