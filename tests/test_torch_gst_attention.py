"""The GST attention variants (``modules/gst_attention.py``) against the
JAX package's, on the CPU in f32: parameters from JAX's seeded init
(jittered, so the zero-initialized u/v biases count), inputs from a numpy
seed, 1e-4 of max(1, |ref|)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from serenade_tpu.modules import gst_attention as jax_gst

from serenade_tpu_torch.convert import flax_paths, load_params
from serenade_tpu_torch.modules import gst_attention

T, HEADS, FEAT = 16, 4, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _jittered(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(
            np.float32), params)


def _close(got, want):
    want = np.asarray(want)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol)


def _mask(rng):
    lengths = np.array([T, 11, 5])
    return (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_multi_headed_attention_matches_jax(masked):
    """Queries of another width than the keys and values (the style token
    layer's dimension-adapting form), square and one-query."""
    rng = np.random.default_rng(1)
    kv = rng.normal(size=(3, T, 24)).astype(np.float32)
    mask = _mask(rng) if masked else None
    jm = jax_gst.MultiHeadedAttention(n_head=HEADS, n_feat=FEAT)
    for tq in (T, 1):
        q = rng.normal(size=(3, tq, 12)).astype(np.float32)
        params = _jittered(jax.jit(jm.init)(jax.random.key(0), q, kv, kv,
                                            key_mask=mask), tq)
        want = jax.jit(jm.apply)(params, q, kv, kv, key_mask=mask)
        port = load_params(gst_attention.MultiHeadedAttention(
            HEADS, FEAT, query_dim=12, key_dim=24, value_dim=24), params)
        got = port(_t(q), _t(kv), _t(kv),
                   key_mask=None if mask is None else _t(mask))
        assert got.shape == (3, tq, FEAT)
        _close(got, want)


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_relative_position_attention_matches_jax(legacy, masked):
    """The relative-position scores (``rel[q, k] = bd[q, k - q + T - 1]``)
    and the legacy left-aligned ``p[:, :, :t]``, with the u/v biases."""
    rng = np.random.default_rng(2 + legacy)
    x = rng.normal(size=(3, T, FEAT)).astype(np.float32)
    pos = rng.normal(size=(1, T if legacy else 2 * T - 1, FEAT)).astype(
        np.float32)
    mask = _mask(rng) if masked else None
    cls = ("LegacyRelPositionMultiHeadedAttention" if legacy
           else "RelPositionMultiHeadedAttention")
    jm = getattr(jax_gst, cls)(n_head=HEADS, n_feat=FEAT)
    params = _jittered(jax.jit(jm.init)(jax.random.key(1), x, pos,
                                        key_mask=mask), 5)
    want = jax.jit(jm.apply)(params, x, pos, key_mask=mask)
    port = load_params(getattr(gst_attention, cls)(HEADS, FEAT), params)
    got = port(_t(x), _t(pos), key_mask=None if mask is None else _t(mask))
    _close(got, want)
    assert set(flax_paths(port)["pos_bias_u"]) == {"params/pos_bias_u"}


def test_relative_positions_change_the_output():
    """As tests/test_gst_attention.py holds JAX's: with nonzero u/v biases a
    shifted positional encoding moves the output, on both sides alike."""
    rng = np.random.default_rng(7)
    t, feat = 16, 16
    x = rng.normal(size=(1, t, feat)).astype(np.float32)
    pos = rng.normal(size=(1, 2 * t - 1, feat)).astype(np.float32)
    jm = jax_gst.RelPositionMultiHeadedAttention(n_head=2, n_feat=feat)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (0.1 if p.shape == (2, 8) else 0.0),
        jax.jit(jm.init)(jax.random.key(2), x, pos))
    port = load_params(gst_attention.RelPositionMultiHeadedAttention(
        2, feat), params)
    rolled = np.roll(pos, 3, axis=1)
    out1, out2 = port(_t(x), _t(pos)), port(_t(x), _t(rolled))
    assert not torch.allclose(out1, out2)
    apply = jax.jit(jm.apply)
    _close(out1, apply(params, x, pos))
    _close(out2, apply(params, x, jnp.asarray(rolled)))
