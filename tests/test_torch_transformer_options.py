"""The transformer options of ``models/transformer.py`` against the JAX
package's, on the CPU in f32: SnakeBeta, the UNet's ``act_fn``, the style
cross-attention and the fused QKV projection (``SERENADE_FUSE_QKV``).
Parameters are random leaves of JAX's parameter shapes (no init is
compiled), inputs from a numpy seed; 1e-4 of max(1, |ref|)."""

import numpy as np
import pytest
import torch

import jax

from serenade_tpu.models import transformer as jax_tx
from serenade_tpu.models.unet import Decoder as JaxDecoder

from serenade_tpu_torch.convert import load_params
from serenade_tpu_torch.models import transformer
from serenade_tpu_torch.models.convert_serenade import reference_name
from serenade_tpu_torch.models.unet import Decoder

DIM, HEADS, HEAD_DIM, STYLE = 32, 4, 16, 24
B, T = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _random_params(module, *args, seed=0, **kwargs):
    """Leaves of ``module``'s parameter shapes (``jax.eval_shape`` of its
    init): norm scales near 1, the rest ~ N(0, 1/fan_in) plus an offset,
    so SnakeBeta's log-scale alpha and beta are not 0."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args,
                                                **kwargs))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 10
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _close(got, want, tol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=0,
        atol=tol * max(1.0, float(np.abs(want).max())))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, DIM)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([T, 11])[:, None]).astype(
        np.float32)
    style = rng.normal(size=(B, STYLE)).astype(np.float32)
    return x, mask, style


def test_snakebeta_feed_forward_matches_jax():
    x, _, _ = _inputs(1)
    jm = jax_tx.FeedForward(dim=DIM, activation_fn="snakebeta")
    params = _random_params(jm, x, seed=1)
    want = jax.jit(jm.apply)(params, x)
    port = load_params(transformer.FeedForward(
        DIM, activation_fn="snakebeta"), params)
    assert isinstance(port.act, transformer.SnakeBeta)
    _close(port(_t(x)), want)
    # anything else is GEGLU, as JAX's selector falls through
    assert isinstance(transformer.FeedForward(DIM, activation_fn="snake").act,
                      transformer.GEGLU)


DEC = dict(in_channels=24, out_channels=8, channels=(32, 32),
           attention_head_dim=16)


def test_snakebeta_unet_matches_jax():
    """``act_fn="snakebeta"`` reaches every transformer block of the UNet
    (6 of them), with a ragged valid length."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, 64, 8)).astype(np.float32)
    mu = rng.normal(size=(B, 64, 16)).astype(np.float32)
    mask = (np.arange(64)[None, :] < np.array([64, 37])[:, None]).astype(
        np.float32)[..., None]
    spk = rng.normal(size=(B, 16)).astype(np.float32)
    t = np.array([0.25, 0.7], np.float32)
    jm = JaxDecoder(**DEC, act_fn="snakebeta")
    params = _random_params(jm, x, mask, mu, t, spk, seed=2)
    want = jax.jit(jm.apply)(params, x, mask, mu, t, spk)
    port = load_params(Decoder(**DEC, spk_dim=16, act_fn="snakebeta"),
                       params)
    blocks = [m for m in port.modules()
              if isinstance(m, transformer.BasicTransformerBlock)]
    assert len(blocks) == 6
    assert all(isinstance(b.ff.act, transformer.SnakeBeta) for b in blocks)
    with torch.no_grad():
        got = port(_t(x), _t(mask), _t(mu), _t(t), _t(spk))
    _close(got, want)


def test_style_cross_attention_block_matches_jax():
    """``norm2`` and ``attn2`` over ``style[:, None, :]`` (a one-token
    context of another width); without a style the block skips them."""
    x, mask, style = _inputs(3)
    jm = jax_tx.BasicTransformerBlock(
        dim=DIM, num_attention_heads=HEADS, attention_head_dim=HEAD_DIM,
        use_style_cross_attn=True)
    params = _random_params(jm, x, key_mask=mask, style=style, seed=3)
    assert {"norm2", "attn2"} <= set(params["params"])
    port = load_params(transformer.BasicTransformerBlock(
        DIM, HEADS, HEAD_DIM, use_style_cross_attn=True, style_dim=STYLE),
        params)
    apply = jax.jit(jm.apply)
    _close(port(_t(x), key_mask=_t(mask), style=_t(style)),
           apply(params, x, key_mask=mask, style=style))
    _close(port(_t(x), key_mask=_t(mask)),
           apply(params, x, key_mask=mask))


def test_fused_qkv_matches_jax_and_the_unfused_port(monkeypatch):
    """``SERENADE_FUSE_QKV=1`` on both sides: one product of x and the
    three weights side by side, the parameters unchanged."""
    x, mask, _ = _inputs(4)
    jm = jax_tx.BasicTransformerBlock(dim=DIM, num_attention_heads=HEADS,
                                      attention_head_dim=HEAD_DIM)
    params = _random_params(jm, x, key_mask=mask, seed=4)
    port = load_params(transformer.BasicTransformerBlock(DIM, HEADS,
                                                         HEAD_DIM), params)
    unfused = port(_t(x), key_mask=_t(mask))
    monkeypatch.setenv("SERENADE_FUSE_QKV", "1")
    assert transformer.default_fuse_qkv() and jax_tx.default_fuse_qkv()
    want = jax.jit(jm.apply)(params, x, key_mask=mask)
    calls = []
    monkeypatch.setattr(transformer.F, "linear", _counting(calls))
    fused = port(_t(x), key_mask=_t(mask))
    # one product for q, k and v, then to_out and the FFN's two
    assert calls[0] == (3 * HEADS * HEAD_DIM, DIM) and len(calls) == 4
    _close(fused, want)
    np.testing.assert_allclose(fused.detach().numpy(),
                               unfused.detach().numpy(), rtol=0, atol=1e-5)


def _counting(calls, linear=torch.nn.functional.linear):
    def counted(x, w, b=None):
        calls.append(tuple(w.shape))
        return linear(x, w, b)
    return counted


def test_reference_names_of_the_options():
    """The reference checkpoints' names of SnakeBeta (``ff.net.0``), the
    style cross-attention's output projection and norm."""
    p = "cfm_decoder.estimator.down0_tx0"
    q = "cfm_decoder.estimator.down_blocks.0.1.0"
    assert reference_name(f"{p}.ff.act") == f"{q}.ff.net.0"
    assert reference_name(f"{p}.ff.act.proj") == f"{q}.ff.net.0.proj"
    assert reference_name(f"{p}.attn2.to_out") == f"{q}.attn2.to_out.0"
    assert reference_name(f"{p}.attn2.to_k") == f"{q}.attn2.to_k"
    assert reference_name(f"{p}.norm2") == f"{q}.norm2"
