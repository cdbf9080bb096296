"""The port's SiFiGAN against the JAX package, on the CPU.

``sifigan/features.py`` (the excitation draw for draw, the dense
factors, ``world_mcep_bap`` with both aperiodicity backends and the
native backend), ``sifigan/generator.py`` (``pd_gather``'s ties, both
generators through the parameter bridge in f32 and in bf16, by the bf16
rule of ``tests/test_torch_models.py``), and ``sifigan/convert.py``
(released-layout checkpoints written from the JAX package's PyTorch twin,
``serenade_tpu/sifigan/torch_twin.py``).  Small widths: channels 32,
upsample (5, 4, 3, 2), two-level filter dilations; the JAX parameters are
random leaves of ``init``'s shapes (``jax.eval_shape``).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serenade_tpu.sifigan import features as jfeat
from serenade_tpu.sifigan import generator as jgen
from serenade_tpu.sifigan.convert import load_sifigan_checkpoint as jload
from serenade_tpu.sifigan.torch_twin import (
    SiFiGANDirectGeneratorTorch, SiFiGANGeneratorTorch,
)

from serenade_tpu_torch.convert import state_dict_from_flax
from serenade_tpu_torch.sifigan import features as pfeat
from serenade_tpu_torch.sifigan import generator as pgen
from serenade_tpu_torch.sifigan.convert import (
    convert_sifigan_generator, load_sifigan_checkpoint,
)
from test_torch_models import assert_bf16_parity

SR = 24000
SCALES = (5, 4, 3, 2)
SMALL = dict(in_channels=43, channels=32, upsample_scales=SCALES,
             upsample_kernel_sizes=(10, 8, 6, 4),
             filter_resblock_kernel_sizes=(3, 5),
             filter_resblock_dilations=((1, 3), (1, 3)))
SMALL_TWIN = dict(
    in_channels=43, channels=32, upsample_scales=SCALES,
    upsample_kernel_sizes=(10, 8, 6, 4),
    source_network_params={
        "resblock_kernel_size": 3,
        "resblock_dilations": [(1,), (1, 2), (1, 2, 4), (1, 2, 4, 8)],
        "use_additional_convs": True},
    filter_network_params={
        "resblock_kernel_sizes": (3, 5),
        "resblock_dilations": [(1, 3), (1, 3)],
        "use_additional_convs": False})
FRAMES = 24


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


def test_signal_generator_matches_jax_draw_for_draw():
    """Sine, noise and V/UV excitation from the same seed, two calls in
    a row: equal to JAX's (the same numpy generator and arithmetic)."""
    f0 = np.concatenate([np.zeros(10), np.full(30, 220.0),
                         np.linspace(220.0, 330.0, 20)])
    kw = dict(sample_rate=SR, hop_size=120, signal_types=("sine", "noise",
                                                          "uv"), seed=7)
    jg, pg = jfeat.SignalGenerator(**kw), pfeat.SignalGenerator(**kw)
    for _ in range(2):
        np.testing.assert_array_equal(pg(f0), jg(f0))


def test_dense_factors_match_jax():
    cf0 = np.linspace(80.0, 900.0, 37)
    want = jfeat.dense_factors_per_level(cf0, SR, [0.5, 1, 4, 8], SCALES)
    got = pfeat.dense_factors_per_level(cf0, SR, [0.5, 1, 4, 8], SCALES)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_pd_gather_rounds_halves_to_even_as_jax():
    """Dilation products on exact halves (0.5, 1.5, 2.5, ...): the taps
    equal JAX's ``jnp.rint`` ones (halves to even, as ``torch.round``),
    and so does the pitch-dependent conv built on them."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 40, 4)).astype(np.float32)
    d = np.tile(np.arange(40, dtype=np.float32) % 7 * 0.5 + 0.5, (2, 1))
    for dil in (1, 3):
        for got, want in zip(pgen.pd_gather(_t(x), _t(d), dil),
                             jgen.pd_gather(jnp.asarray(x), jnp.asarray(d),
                                            dil)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    k = rng.normal(size=(3, 4, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    want = jgen.pitch_dependent_conv(jnp.asarray(x), jnp.asarray(d),
                                     jnp.asarray(k), jnp.asarray(b), 2)
    got = pgen.pitch_dependent_conv(_t(x), _t(d), _t(k), _t(b), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# -- aux features -------------------------------------------------------------


def _tone(seconds=0.7, f0=220.0, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    ph = 2 * np.pi * f0 * (t + 0.002 * np.sin(2 * np.pi * 5 * t))
    x = sum((0.5 / h) * np.sin(h * ph) for h in range(1, 9))
    return (x + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def _track(n, f0=220.0):
    f0s = np.full(n, f0, np.float32)
    f0s[:6] = 0.0
    return f0s


@pytest.mark.parametrize("ap_backend,bap_tol", [("bandap", 1e-2),
                                                ("d4c", 0.25)])
def test_world_mcep_bap_matches_jax(ap_backend, bap_tol):
    """One bucket-padded analysis on each side, the frames cut at the
    track's length, held against JAX's ops in f64 (``jax.enable_x64``) on
    the same padded input: the mel-cepstrum (``sp2mc`` of CheapTrick)
    within 1e-4 and bap within 1e-3 dB (measured 1.4e-6 and 5.3e-5).
    Against JAX's f32 ``world_mcep_bap``: the mel-cepstrum within 3e-2
    and bap within 1e-2 dB (band aperiodicity) or 0.25 dB (D4C), where
    JAX's f32 sums put its own result 0.012, 1e-4 dB and 0.155 dB from
    its f64 one on this tone (tests/test_torch_world.py)."""
    from serenade_tpu.ops import world as jworld
    from serenade_tpu.ops.sptk import sp2mc

    x = _tone()
    f0 = _track(1 + len(x) // 120)
    want = jfeat.world_mcep_bap(x, f0, SR, 5.0, 39, ap_backend=ap_backend)
    got = pfeat.world_mcep_bap(x, f0, SR, 5.0, 39, ap_backend=ap_backend,
                               device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape
    assert got[0].shape == (len(f0), 40)
    padded = 128 * 120 * -(-len(x) // (128 * 120))
    ap_fn = jworld.d4c if ap_backend == "d4c" else jworld.band_aperiodicity
    with jax.enable_x64(True):
        args = (jnp.asarray(np.pad(x, (0, padded - len(x))), jnp.float64),
                jnp.asarray(np.pad(f0, (0, 1 + padded // 120 - len(f0))),
                            jnp.float64))
        sp64 = np.asarray(jworld.cheaptrick(*args, fs=SR))[:len(f0)]
        bap64 = np.asarray(ap_fn(*args, fs=SR))[:len(f0)]
    np.testing.assert_allclose(got[0], sp2mc(sp64, 39, 0.466), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got[1], bap64, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[0], want[0], atol=3e-2, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=bap_tol, rtol=0)


def test_world_mcep_bap_refuses_by_name():
    x = _tone(0.2)
    f0 = _track(1 + len(x) // 120)
    with pytest.raises(ValueError, match="band aperiodicity only"):
        pfeat.world_mcep_bap(x, f0, SR, 5.0, 39, ap_backend="d4c",
                             analysis_backend="native")
    with pytest.raises(ValueError, match="analysis_backend"):
        pfeat.world_mcep_bap(x, f0, SR, 5.0, 39, analysis_backend="jax",
                             device="cpu")


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="no g++: the native library cannot build")
def test_world_mcep_bap_native_matches_device():
    """The native backend against JAX's native backend on the same
    inputs: the same C++ CheapTrick and band aperiodicity and the same
    host ``sp2mc`` on both sides, so mcep, bap and the envelope within
    1e-9 relative (measured equal).  Beside it, against the port's device
    path by JAX's tests/test_native.py rule: mel-cepstrum past c0 within
    0.05, bap within 0.25 dB."""
    x = _tone(seed=6)
    f0 = _track(1 + len(x) // 120)
    nat = pfeat.world_mcep_bap(x, f0, SR, 5.0, 39, analysis_backend="native")
    want = jfeat.world_mcep_bap(x, f0, SR, 5.0, 39, analysis_backend="native")
    for g, w in zip(nat, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=0)
    assert nat[1].shape == (len(f0), 3) and nat[1].min() < -1.0
    dev = pfeat.world_mcep_bap(x, f0, SR, 5.0, 39, device="cpu")
    np.testing.assert_allclose(nat[0][:, 1:], dev[0][:, 1:], atol=0.05)
    np.testing.assert_allclose(nat[1], dev[1], atol=0.25)


# -- the generators ----------------------------------------------------------


def _inputs(seed=0, frames=FRAMES):
    """Aux features, an excitation and per-level dilation factors in [1,
    4], from a seed."""
    rng = np.random.default_rng(seed)
    total = int(np.prod(SCALES))
    c = rng.normal(size=(2, frames, 43)).astype(np.float32)
    sine = (0.1 * np.sin(np.linspace(0, 90, frames * total))).astype(
        np.float32)
    sine = np.stack([sine, -sine])[..., None]
    dfs = [(1.0 + 3.0 * rng.random((2, frames * int(k)))).astype(np.float32)
           for k in np.cumprod(SCALES)]
    return sine, c, dfs


def _seeded_tree(shapes, seed):
    """Random leaves of ``init``'s shapes: kernels N(0, 1/fan_in), biases
    N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if len(s.shape) >= 2:
            return (rng.normal(size=s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.05 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map(leaf, shapes)


VARIANTS = {
    "sifigan": (jgen.SiFiGANGenerator, pgen.SiFiGANGenerator),
    "direct": (jgen.SiFiGANDirectGenerator, pgen.SiFiGANDirectGenerator),
}


@pytest.fixture(scope="module")
def jax_outputs():
    """Per generator: the flax tree and JAX's (waveform, excitation) in
    f32 and in bf16 (shared up- and downsamples go through the bridge in
    ``test_released_checkpoint_converts``)."""
    sine, c, dfs = _inputs()
    out = {}
    for seed, (name, (jcls, _)) in enumerate(VARIANTS.items(), 1):
        params = None
        for dtype in (jnp.float32, jnp.bfloat16):
            model = jcls(**SMALL, dtype=dtype)
            if params is None:
                shapes = jax.eval_shape(model.init, jax.random.key(0), sine,
                                        c, dfs)
                params = _seeded_tree(shapes, seed)
            y, e = jax.jit(model.apply)(params, sine, c, dfs)
            out[(name, str(np.dtype(dtype)))] = (
                np.asarray(y, np.float32), np.asarray(e, np.float32))
        out[name] = params
    return out


def _port(name, params, dtype=torch.float32):
    model = VARIANTS[name][1](**SMALL, dtype=dtype)
    model.load_state_dict(state_dict_from_flax(model, params), strict=True)
    return model.eval()


@pytest.mark.parametrize("name", list(VARIANTS))
def test_generator_matches_jax_f32(jax_outputs, name):
    """Both generators through the parameter bridge: the waveform and the
    excitation within 1e-4 of JAX's in f32 (convolutions summed in
    another order)."""
    sine, c, dfs = _inputs()
    model = _port(name, jax_outputs[name])
    with torch.no_grad():
        y, e = model(_t(sine), _t(c), [_t(d) for d in dfs])
    want_y, want_e = jax_outputs[(name, "float32")]
    assert y.shape == want_y.shape == (2, FRAMES * 120, 1)
    np.testing.assert_allclose(y.numpy(), want_y, atol=1e-4, rtol=0)
    np.testing.assert_allclose(e.numpy(), want_e, atol=1e-4, rtol=0)
    assert np.abs(want_y).max() > 0.05


@pytest.mark.parametrize("name", list(VARIANTS))
def test_generator_matches_jax_bf16(jax_outputs, name):
    """bf16 compute with f32 parameters on both sides: the waveform and
    the excitation held by the bf16 rule (``assert_bf16_parity``: against
    JAX's bf16 within 1.5x JAX's mean bf16 - f32 gap and 2x its max, the
    port's own gap within 1.25x JAX's and at least half its mean)."""
    sine, c, dfs = _inputs()
    model = _port(name, jax_outputs[name], torch.bfloat16)
    with torch.no_grad():
        y, e = model(_t(sine), _t(c), [_t(d) for d in dfs])
    for got, want16, want32 in zip(
            (y.float().numpy(), e.float().numpy()),
            jax_outputs[(name, "bfloat16")],
            jax_outputs[(name, "float32")]):
        assert_bf16_parity(got, want16, want32)


# -- released checkpoints ------------------------------------------------------


@pytest.mark.parametrize("direct,share", [(False, False), (False, True),
                                          (True, False)])
def test_released_checkpoint_converts(tmp_path, direct, share):
    """A weight-normed twin saved as ``{"model": {"generator": sd}}``:
    the port's conversion equals the JAX converter's tree through the
    bridge within 1e-6 relative (weight norm folded in another order of
    f32 operations), and the converted port generator reproduces the
    twin's waveform and excitation within 1e-4."""
    torch.manual_seed(3)
    kw = dict(share_upsamples=share)
    if direct:
        twin = SiFiGANDirectGeneratorTorch(**SMALL_TWIN, **kw)
        jmodel = jgen.SiFiGANDirectGenerator(**SMALL, **kw)
        model = pgen.SiFiGANDirectGenerator(**SMALL, **kw)
    else:
        kw["share_downsamples"] = share
        twin = SiFiGANGeneratorTorch(**SMALL_TWIN, **kw)
        jmodel = jgen.SiFiGANGenerator(**SMALL, **kw)
        model = pgen.SiFiGANGenerator(**SMALL, **kw)
    path = tmp_path / "sifigan.pkl"
    torch.save({"model": {"generator": twin.eval().state_dict()}}, path)
    sd = load_sifigan_checkpoint(str(path), model)
    via_jax = state_dict_from_flax(model, jload(str(path), jmodel))
    assert sd.keys() == via_jax.keys() == model.state_dict().keys()
    for k in sd:
        torch.testing.assert_close(sd[k], via_jax[k], rtol=1e-6, atol=0)
    model.load_state_dict(sd, strict=True)
    sine, c, dfs = _inputs(seed=4, frames=12)
    with torch.no_grad():
        y_t, e_t = twin(_t(sine).transpose(1, 2), _t(c).transpose(1, 2),
                        [_t(d)[:, None] for d in dfs])
        y, e = model.eval()(_t(sine), _t(c), [_t(d) for d in dfs])
    np.testing.assert_allclose(y[..., 0].numpy(), y_t[:, 0].numpy(),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(e[..., 0].numpy(), e_t[:, 0].numpy(),
                               atol=1e-4, rtol=0)


def test_released_checkpoint_refuses_naming_drift():
    """A key no module takes, and a conv the checkpoint lacks, raise with
    the names."""
    model = pgen.SiFiGANGenerator(**SMALL)
    twin = SiFiGANGeneratorTorch(**SMALL_TWIN)
    sd = dict(twin.state_dict())
    sd["sn.extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="sn.extra.weight"):
        convert_sifigan_generator(sd, model)
    sd.pop("sn.extra.weight")
    for k in [k for k in sd if k.startswith("sn.emb")]:
        sd.pop(k)
    with pytest.raises(KeyError, match="sn.emb"):
        convert_sifigan_generator(sd, model)
