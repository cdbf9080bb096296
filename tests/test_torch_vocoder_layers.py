"""The port's vocoder conv blocks (``serenade_tpu_torch/vocoder/layers.py``)
against the JAX package's, on the CPU.

Each block's flax parameters are seeded numpy leaves of the shapes
``jax.eval_shape(init)`` gives, loaded into the port through
``convert.state_dict_from_flax``; both sides run the same seeded inputs.
f32 is held within 1e-5 of the reference's peak, bf16 by the rule of
``test_torch_models.assert_bf16_parity``.  Small widths; the upsampling
network runs at scales whose product is the recipe's hop of 240
(``egs/gtsinger/ssc1/conf/serenade.yaml``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serenade_tpu.vocoder import layers as jl

from serenade_tpu_torch.convert import load_params
from serenade_tpu_torch.vocoder import layers as pl
from test_torch_models import assert_bf16_parity

REL = 1e-5
HOP_SCALES = (4, 5, 3, 4)           # 240 samples a frame


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wavenet(causal, with_c):
    kw = dict(residual_channels=12, gate_channels=16, skip_channels=10,
              kernel_size=3, dilation=4, use_causal=causal)
    return (lambda dt: jl.WaveNetResidualBlock(**kw, aux_channels=6,
                                               dtype=dt),
            lambda dt: pl.WaveNetResidualBlock(
                **kw, aux_channels=6 if with_c else 0, dtype=dt),
            (2, 40, 12), (2, 40, 6) if with_c else None)


# name -> (flax module of a dtype, port module of a dtype, x shape,
# conditioning shape or None)
BLOCKS = {
    "causal_conv": (
        lambda dt: jl.CausalConv1d(10, kernel_size=3, dilation=2, dtype=dt),
        lambda dt: pl.CausalConv1d(6, 10, kernel_size=3, dilation=2,
                                   dtype=dt),
        (2, 33, 6), None),
    "causal_deconv": (
        lambda dt: jl.CausalConvTranspose1d(5, kernel_size=8, stride=4,
                                            dtype=dt),
        lambda dt: pl.CausalConvTranspose1d(7, 5, kernel_size=8, stride=4,
                                            dtype=dt),
        (2, 17, 7), None),
    "wavenet_centred_c": _wavenet(False, True),
    "wavenet_centred": _wavenet(False, False),
    "wavenet_causal_c": _wavenet(True, True),
    "wavenet_causal": _wavenet(True, False),
    "melgan_stack": (
        lambda dt: jl.MelGANResidualStack(channels=12, kernel_size=3,
                                          dilation=3, dtype=dt),
        lambda dt: pl.MelGANResidualStack(channels=12, kernel_size=3,
                                          dilation=3, dtype=dt),
        (2, 29, 12), None),
    "stretch2d": (
        lambda dt: jl.Stretch2d(3, 2), lambda dt: pl.Stretch2d(3, 2),
        (2, 7, 5), None),
    "upsample": (
        lambda dt: jl.UpsampleNetwork((2, 3), dtype=dt),
        lambda dt: pl.UpsampleNetwork((2, 3), dtype=dt),
        (2, 9, 8), None),
    "conv_in_upsample": (
        lambda dt: jl.ConvInUpsampleNetwork(HOP_SCALES, aux_channels=16,
                                            aux_context_window=2, dtype=dt),
        lambda dt: pl.ConvInUpsampleNetwork(HOP_SCALES, aux_channels=16,
                                            aux_context_window=2, dtype=dt),
        (2, 8, 16), None),
}
# the blocks with parameters and a compute dtype
BF16 = [n for n in BLOCKS if n != "stretch2d"]


def _inputs(name):
    _, _, x_shape, c_shape = BLOCKS[name]
    rng = np.random.default_rng(sorted(BLOCKS).index(name))
    x = rng.normal(size=x_shape).astype(np.float32)
    c = None if c_shape is None else rng.normal(size=c_shape).astype(
        np.float32)
    return x, c


def _flax_params(module, x, c, seed):
    """Seeded leaves of the shapes flax's init gives (nothing compiled);
    biases too, so that the bridge's placement of each shows."""
    args = (x,) if c is None else (x, c)
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(s):
        fan_in = int(np.prod(s.shape[:-1])) or 1
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree.map(leaf, shapes)


def _run(name, jdt=jnp.float32, pdt=torch.float32, seed=1):
    """(port output(s), JAX output(s)) as numpy f32."""
    jmod, pmod, _, _ = BLOCKS[name]
    x, c = _inputs(name)
    jax_mod = jmod(jdt)
    params = _flax_params(jax_mod, x, c, seed)
    args = (x,) if c is None else (x, c)
    want = jax.jit(jax_mod.apply)(params, *map(jnp.asarray, args))
    port = pmod(pdt)
    if params:
        load_params(port, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args))

    def host(t):
        return (tuple(map(host, t)) if isinstance(t, tuple)
                else np.asarray(t.float() if isinstance(t, torch.Tensor)
                                else t, np.float32))

    return host(got), host(want)


def assert_close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    """f32: the port's block, through the weight bridge, equals JAX's
    within 1e-5 of its peak (WaveNet: both the residual and the skip)."""
    got, want = _run(name)
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            assert_close(g, w)
    else:
        assert_close(got, want)


@pytest.mark.parametrize("name", BF16)
def test_block_bf16_matches_jax(name):
    """bf16 compute with f32 parameters on both sides, held against JAX's
    own bf16 - f32 gap (``assert_bf16_parity``)."""
    got, want = _run(name, jnp.bfloat16, torch.bfloat16)
    _, ref = _run(name)
    pairs = (zip(got, want, ref) if isinstance(want, tuple)
             else [(got, want, ref)])
    for g, w, r in pairs:
        assert_bf16_parity(g, w, r)


def test_conv_in_upsample_gives_a_hop_a_frame():
    """240 samples a frame after the context conv takes 2 frames off each
    end, as ParallelWaveGAN's generator feeds its WaveNet stack."""
    got, _ = _run("conv_in_upsample")
    assert got.shape == (2, (8 - 4) * 240, 16)


@pytest.mark.parametrize("name", ["causal_conv", "causal_deconv",
                                  "wavenet_causal_c"])
def test_causal_blocks_are_causal(name):
    """Changing the input after frame t leaves the outputs up to t (up to
    the end of t's upsampled span) unchanged, and changes a later one."""
    _, pmod, _, _ = BLOCKS[name]
    torch.manual_seed(0)
    block = pmod(torch.float32)
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.3)
    x, c = map(lambda a: None if a is None else torch.from_numpy(a),
               _inputs(name))
    t = 10
    x2 = x.clone()
    x2[:, t + 1:] += 1.0
    args2 = (x2,) if c is None else (x2, c)
    with torch.no_grad():
        y = block(*((x,) if c is None else (x, c)))
        y2 = block(*args2)
    if isinstance(y, tuple):
        y, y2 = y[1], y2[1]
    keep = (t + 1) * getattr(block, "stride", 1)
    torch.testing.assert_close(y2[:, :keep], y[:, :keep], rtol=0, atol=0)
    assert (y2[:, keep:] - y[:, keep:]).abs().max() > 0


def test_wavenet_without_aux_conv_refuses_conditioning():
    block = pl.WaveNetResidualBlock(residual_channels=4, gate_channels=4,
                                    skip_channels=4, aux_channels=0)
    assert block.aux_conv is None
    with pytest.raises(ValueError, match="aux_channels=0"):
        block(torch.zeros(1, 5, 4), torch.zeros(1, 5, 3))
