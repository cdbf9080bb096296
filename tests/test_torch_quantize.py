"""int8 quantization of the port (``serenade_tpu_torch/quantize.py``, the
Dense layer's int8 products, ``Converter(quantize=...)``) against the JAX
package's ``serenade_tpu/quantize.py`` and its Converter.

The JAX parameters are random leaves of the shapes ``init`` gives
(``jax.eval_shape``) at a width where the traps show: a fused GRU weight
whose flax gate kernels are each below ``MIN_QUANT_SIZE`` while the three
together are above it, a transposed conv and an embedding table whose
channel is not the port's first axis.  The Converters run the decode
tests' experiment (``tests/test_torch_decode.py``).  Small widths, f32,
on the CPU.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from serenade_tpu import quantize as jq
from serenade_tpu.models.serenade import Serenade as JaxSerenade
from serenade_tpu_torch import quantize as pq
from serenade_tpu_torch.api import Converter
from serenade_tpu_torch.convert import flax_paths, state_dict_from_flax
from serenade_tpu_torch.models.layers import Dense
from serenade_tpu_torch.models.serenade import Serenade
from tests.test_torch_decode import (  # noqa: F401 (fixtures)
    MEL_TOL, WAV_TOL, expdirs, files,
)
from tests.test_torch_variant import _seeded_tree

# GST: 80 mels over four stride-2 convs leave 5 bins of 16 channels, so the
# GRU's flax gate kernels are (80, 32), 2,560 elements each, and its fused
# input weight (96, 80) 7,680; 64 style tokens of 64 make a 4,096 table
CFG = dict(input_dim=32, output_dim=80, encoder_channels=16,
           encoder_hidden_dim=64, decoder_channels=64, gst_embed_dim=256,
           decoder_attention_head_dim=32, gst_tokens=64,
           gst_conv_chans=(8, 8, 16, 16), gst_gru_units=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bridged():
    """Seeded JAX parameters at ``CFG`` and the port's Serenade with the
    same weights through the bridge."""
    jmodel = JaxSerenade(**CFG, dtype=jnp.float32)
    key = jax.random.key(0)
    z = lambda *s: jnp.zeros(s, jnp.float32)   # noqa: E731
    lens = jnp.ones((1,), jnp.int32)
    shapes = jax.eval_shape(
        lambda: jmodel.init(key, z(1, 64, 32), lens, z(1, 64, 1),
                            z(1, 64, 1), z(1, 64, 32), lens, z(1, 64, 80),
                            z(1, 64, 1), z(1, 64, 1), rng=key, n_timesteps=1,
                            method="inference"))
    jparams = _seeded_tree(shapes, 3)
    model = Serenade(**CFG, dtype="float32")
    model.load_state_dict(state_dict_from_flax(model, jparams))
    return jparams, model


def _jax_qpaths(tree):
    """The "/"-joined paths of the QTensor leaves of a JAX tree."""
    return {"/".join(str(k.key) for k in path)
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, jq.QTensor))
            if isinstance(leaf, jq.QTensor)}


# (flax layout, how the bridge lays it out, the port's channel axis)
LEAVES = {
    "dense": ((96, 48), lambda w: w.T, 0),
    "conv": ((3, 24, 64), lambda w: w.transpose(2, 1, 0), 0),
    "conv_transpose": ((4, 32, 40), lambda w: w.transpose(1, 2, 0), 1),
    "embedding": ((64, 80), lambda w: w, 1),
}


@pytest.mark.parametrize("case", sorted(LEAVES))
def test_quantize_leaf_matches_jax(case):
    """Per-channel int8 of one weight in the port's layout against JAX's of
    its flax layout: the int8 values bit-equal, the scales within 1e-7
    relative (both f32: they are equal here)."""
    shape, to_port, axis = LEAVES[case]
    w = np.random.default_rng(len(case)).normal(size=shape).astype(
        np.float32)
    w[..., 3] *= 40.0          # a hot channel widens only its own scale
    want = jq.quantize_leaf(w)
    got = pq.quantize_leaf(torch.from_numpy(np.ascontiguousarray(
        to_port(w))), axis)
    np.testing.assert_array_equal(
        got.q.numpy(), to_port(np.asarray(want.q)))
    np.testing.assert_allclose(
        got.scale.numpy(), to_port(np.asarray(want.scale)), rtol=1e-7,
        atol=0)
    back = got.dequantize().numpy()
    bound = np.abs(to_port(w)).max(axis=tuple(
        d for d in range(w.ndim) if d != axis), keepdims=True) / 254.0
    assert (np.abs(back - to_port(w)) <= bound + 1e-7).all()


@pytest.mark.parametrize("mode", ["int8", "int8_compute"])
def test_quantized_leaves_and_bytes_match_jax(bridged, mode):
    """The leaves ``quantize_tree`` (every eligible weight) and
    ``quantize_dense_tree`` (the estimator's 2-D kernels) choose on bridged
    parameters, mapped to flax paths, are JAX's; ``quantized_bytes``
    equals JAX's.  The fused GRU input weight stays float: each of its
    three gate kernels is below the size floor."""
    jparams, model = bridged
    if mode == "int8":   # jitted, as JAX's Converter quantizes
        jtree = jax.jit(jq.quantize_tree)(jparams)
        state = pq.quantize_tree(model)
    else:
        jtree = jax.jit(jq.quantize_dense_tree)(jparams)
        state = pq.quantize_dense_tree(model)
    paths = flax_paths(model)
    got = {p for name in pq.split_quantized(state) for p in paths[name]}
    want = _jax_qpaths(jtree)
    assert got == want and want
    assert pq.quantized_bytes(state) == jq.quantized_bytes(jtree)
    gru = "params/gst/ref_enc/MaskedGRU_0/GRUCell_0/ir/kernel"
    assert gru not in got
    assert model.gst.ref_enc.gru.weight_ih.numel() >= pq.MIN_QUANT_SIZE
    if mode == "int8":
        # the transposed conv and the token table, by their own channels
        assert "params/gst/stl/gst_embs" in got
        assert any("upsample/kernel" in p for p in got)
        assert pq.quantized_bytes(state) < 0.35 * sum(
            v.numel() * 4 for v in model.state_dict().values())
    else:
        assert all("/estimator/" in p and p.endswith("/kernel")
                   for p in got)


def _jax_int8_parts(x, qt):
    """JAX's ``int8_dot`` step by step: the activations' int8 values and
    scales, and the int32 sums of the product."""
    xf = x.astype(jnp.float32)
    s_x = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True),
                      1e-12) / 127.0
    xq = jnp.clip(jnp.round(xf / s_x), -127, 127).astype(jnp.int8)
    y = jax.lax.dot_general(xq, qt.q, (((x.ndim - 1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    return np.asarray(xq), np.asarray(s_x), np.asarray(y)


def test_int8_dot_matches_jax():
    """The activations' int8 values bit-equal, the int32 sums exact, the
    result within 1e-6 relative; and JAX's own bound against the f32
    product (``tests/test_quantize.py``), under 1.5 %."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 96, 512)).astype(np.float32)
    w = (rng.normal(size=(512, 1024)) / np.sqrt(512)).astype(np.float32)
    jqt = jq.quantize_leaf(w)
    want = np.asarray(jq.int8_dot(jnp.asarray(x), jqt))
    xq_j, s_j, y_j = _jax_int8_parts(jnp.asarray(x), jqt)
    qt = pq.quantize_leaf(torch.from_numpy(np.ascontiguousarray(w.T)), 0)
    xt = torch.from_numpy(x)
    xq, s_x = pq.quantize_rows(xt)
    np.testing.assert_array_equal(xq.numpy(), xq_j)
    np.testing.assert_array_equal(s_x.numpy(), s_j)
    y = pq.int8_matmul(xq.reshape(-1, 512), qt.q).reshape(4, 96, 1024)
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), y_j)
    got = pq.int8_dot(xt, qt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ref = x @ w
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.015
    # the plain product stays exact past f32's 2^24: 127 x 127 x 2048
    a = torch.full((3, 2048), 127, dtype=torch.int8)
    assert int(pq.int8_matmul_plain(a, a)[0, 0]) == 127 * 127 * 2048


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_float_path_unchanged_and_int8_path(dtype):
    """A float weight runs ``F.linear`` in the layer's dtype, bit for bit;
    ``use_int8_`` drops the float weight and runs ``int8_dot`` plus the
    bias in that dtype, as QDense does."""
    torch.manual_seed(0)
    layer = Dense(48, 96, dtype=dtype)
    torch.nn.init.normal_(layer.weight)
    torch.nn.init.normal_(layer.bias)
    x = torch.randn(3, 17, 48)
    want = F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))
    assert torch.equal(layer(x), want)
    w, b = layer.weight.detach().clone(), layer.bias.detach().clone()
    qt = pq.quantize_leaf(w, 0)
    layer.use_int8_(qt)
    assert "weight" not in layer.state_dict()
    assert layer.state_dict()["weight_q"].dtype == torch.int8
    assert torch.equal(layer(x), pq.int8_dot(x, qt, dtype=dtype)
                       + b.to(dtype))


def _jax_converter(files, quantize):
    from serenade_tpu.api import Converter as JaxConverter

    return JaxConverter(str(files["root"] / "exp_jax"), files["stats"],
                        temperature=0.0, quantize=quantize)


def test_from_expdir_int8_matches_jax(files, expdirs):
    """``Converter.from_expdir(quantize="int8")`` against JAX's
    ``Converter(quantize="int8")`` on the same experiment at temperature 0:
    mel and waveform within the decode tests' tolerances.  The int8
    weights stay int8 on the device (their float parameters are gone)."""
    conv = Converter.from_expdir(str(expdirs["pdir"]), files["stats"],
                                 temperature=0.0, device="cpu",
                                 quantize="int8")
    assert conv.quantize == "int8" and conv._qweights
    names = set(dict(conv.model.named_parameters()))
    assert not names & set(conv._qweights)
    mel, wav, _ = conv.convert_features(expdirs["src"], expdirs["ref"])
    mel_j, wav_j, _ = _jax_converter(files, "int8").convert_features(
        expdirs["src"], expdirs["ref"])
    np.testing.assert_allclose(mel, mel_j, rtol=MEL_TOL, atol=MEL_TOL)
    np.testing.assert_allclose(wav, wav_j, rtol=WAV_TOL, atol=WAV_TOL)
    assert np.abs(mel - expdirs["mel"]).max() > 10 * MEL_TOL   # int8 acts


def test_from_expdir_int8_compute_within_jax_gap(files, expdirs):
    """``"int8_compute"``: a rounding flip in an activation's int8 value
    makes exact parity impossible, so port - JAX is held within 1.5x the
    mean and 2x the max of JAX's own (int8_compute - f32) gap."""
    conv = Converter.from_expdir(str(expdirs["pdir"]), files["stats"],
                                 temperature=0.0, device="cpu",
                                 quantize="int8_compute")
    assert any(m.weight_q is not None for m in conv.model.modules()
               if isinstance(m, Dense))
    mel, _, _ = conv.convert_features(expdirs["src"], expdirs["ref"])
    mel_j, _, _ = _jax_converter(files, "int8_compute").convert_features(
        expdirs["src"], expdirs["ref"])
    gap = np.abs(mel_j - expdirs["mel"])
    err = np.abs(mel - mel_j)
    assert gap.max() > 0
    assert err.mean() <= 1.5 * gap.mean(), (err.mean(), gap.mean())
    assert err.max() <= 2.0 * gap.max(), (err.max(), gap.max())


def test_quantize_mode_refused_by_name(files, expdirs):
    with pytest.raises(ValueError, match="quantize"):
        Converter.from_expdir(str(expdirs["pdir"]), files["stats"],
                              device="cpu", quantize="int4")


# every path the int8 weights must reach: the same conversion by a
# Converter given the dequantized weights as its float parameters
PATHS = ("convert_features", "convert_features_long", "style_embedding",
         "variant")


@pytest.mark.parametrize("path", PATHS)
def test_every_path_sees_the_int8_weights(bridged, path):
    _, model = bridged
    rng = np.random.default_rng(5)
    sc = {"hubert": {"mean": np.zeros(32), "scale": np.ones(32)},
          "score": {"min": 0.0, "max": 1.0}, "loud": {"min": 0.0, "max": 1.0},
          "logmel": {"mean": np.zeros(80), "scale": np.ones(80)}}
    cfg, kind, extra = dict(CFG, dtype="float32"), "Serenade", {}
    sd = model.state_dict()
    if path == "variant":
        from serenade_tpu_torch.models.serenade_new import SerenadeNew

        kind = "SerenadeNew"
        variant = SerenadeNew(**cfg)
        sd = {k: torch.randn(v.shape, generator=torch.Generator()
                             .manual_seed(i)) * 0.1
              for i, (k, v) in enumerate(variant.state_dict().items())}
        variant.load_state_dict(sd)
        deq = pq.dequantize_tree(pq.quantize_tree(variant))
        extra = {"f0_fluc": None}
    else:
        deq = pq.dequantize_tree(pq.quantize_tree(model))
    q = Converter(cfg, sd, sc, n_timesteps=2, seed=2, device="cpu",
                  model_type=kind, quantize="int8")
    f = Converter(cfg, deq, sc, n_timesteps=2, seed=2, device="cpu",
                  model_type=kind)

    def feats(t, mel):
        out = {"hubert": rng.normal(size=(t, 32)), "score": rng.random(t),
               "loud": rng.random(t)}
        if mel:
            out["logmel"] = rng.normal(size=(t, 80))
        if extra:
            out["f0_fluc"] = rng.normal(size=(t, 1))
        return out

    src, ref = feats(300, False), feats(90, True)
    if path == "style_embedding":
        got, want = (c.style_embedding(logmel=ref["logmel"]) for c in (q, f))
    elif path == "convert_features_long":
        got, want = (c.convert_features_long(src, ref, chunk_frames=128,
                                             overlap_frames=32)[0]
                     for c in (q, f))
    else:
        got, want = (c.convert_features(src, ref)[0] for c in (q, f))
    np.testing.assert_array_equal(got, want)
