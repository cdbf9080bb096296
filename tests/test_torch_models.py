"""The port's modules against the JAX package at small widths, on the CPU.

Parameters come from each JAX module's seeded ``init``, go to numpy and
through ``serenade_tpu_torch.convert``; inputs are made with numpy from a
seed and given to both.  All in f32 (the tests pin JAX's matmul precision
to float32, conftest), so the tolerances cover summation order; where an
output passes through several normalizations or ODE steps the tolerance
is stated beside the test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from serenade_tpu.models.cfm import CFM as JaxCFM
from serenade_tpu.models.conv1d_resnet import Conv1dResnet as JaxResnet
from serenade_tpu.models.gst import StyleEncoder as JaxStyle
from serenade_tpu.models.layers import (
    conv_transpose1d as jax_conv_transpose1d,
    sinusoidal_time_embedding as jax_sinusoidal,
)
from serenade_tpu.models.unet import Decoder as JaxDecoder
from serenade_tpu.ops.sequence import (
    pack_pair_time as jax_pack,
    unpack_suffix_time as jax_unpack,
)
from serenade_tpu.vocoder.hifigan import HiFiGANGenerator as JaxHiFiGAN

from serenade_tpu_torch.collaters.ssc import bucket_length, pad_to
from serenade_tpu_torch.convert import load_params
from serenade_tpu_torch.models.cfm import CFM
from serenade_tpu_torch.models.conv1d_resnet import Conv1dResnet
from serenade_tpu_torch.models.gst import StyleEncoder
from serenade_tpu_torch.models.layers import (
    conv_transpose1d,
    sinusoidal_time_embedding,
)
from serenade_tpu_torch.models.unet import Decoder
from serenade_tpu_torch.ops.sequence import pack_pair_time, unpack_suffix_time
from serenade_tpu_torch.utils.masking import length_mask
from serenade_tpu_torch.vocoder.hifigan import HiFiGANGenerator


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _jitter(params, seed, scale=0.1):
    """Perturb every leaf so zero-initialized biases and unit norm scales
    (and the identity SpeakerAdapter) are exercised too."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + scale * rng.normal(size=a.shape)).astype(np.float32),
        params)


# ---------------------------------------------------------------------------
# small ops
# ---------------------------------------------------------------------------


def test_pack_unpack_per_sample_offsets():
    rng = np.random.default_rng(0)
    ref = rng.normal(size=(3, 8, 4)).astype(np.float32)
    src = rng.normal(size=(3, 6, 4)).astype(np.float32)
    rl, sl = np.array([8, 3, 5]), np.array([6, 2, 4])
    packed, total = pack_pair_time(_t(ref), torch.tensor(rl), _t(src),
                                   torch.tensor(sl))
    j_packed, j_total = jax_pack(jnp.asarray(ref), jnp.asarray(rl),
                                 jnp.asarray(src), jnp.asarray(sl))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_packed))
    np.testing.assert_array_equal(total.numpy(), np.asarray(j_total))
    out = unpack_suffix_time(packed, torch.tensor(rl), 6)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax_unpack(j_packed, jnp.asarray(rl), 6)))
    np.testing.assert_array_equal(
        length_mask(torch.tensor([2, 0]), 3).numpy(), [[1, 1, 0], [0, 0, 0]])


def test_bucketing_copies_match():
    from serenade_tpu.collaters import ssc

    for n in (1, 63, 64, 65, 1024, 1500):
        assert bucket_length(n) == ssc.bucket_length(n)
    x = np.arange(10.0).reshape(5, 2)
    np.testing.assert_array_equal(pad_to(x, 8), ssc.pad_to(x, 8))
    np.testing.assert_array_equal(pad_to(x, 3), ssc.pad_to(x, 3))


@pytest.mark.parametrize("stride,k", [(8, 16), (6, 12), (5, 10), (2, 4)])
def test_conv_transpose_geometry(stride, k):
    """HiFiGAN's padding s//2 + s%2 and output_padding s%2 (odd scales)."""
    rng = np.random.default_rng(stride)
    x = rng.normal(size=(1, 7, 3)).astype(np.float32)
    w = rng.normal(size=(k, 3, 2)).astype(np.float32)   # flax (k, in, out)
    pad, op = stride // 2 + stride % 2, stride % 2
    got = conv_transpose1d(_t(x), _t(np.transpose(w, (1, 2, 0))),
                           stride=stride, padding=pad, output_padding=op)
    want = jax_conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                                stride=stride, padding=pad,
                                output_padding=op, backend="lax")
    assert got.shape == (1, 7 * stride, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_sinusoidal_embedding():
    t = np.array([0.0, 0.3, 1.0], np.float32)
    np.testing.assert_allclose(
        sinusoidal_time_embedding(_t(t), 242).numpy(),
        np.asarray(jax_sinusoidal(jnp.asarray(t), 242)), rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# UNet, CFM
# ---------------------------------------------------------------------------

DEC = dict(in_channels=24, out_channels=8, channels=(32, 32),
           attention_head_dim=16)


def _decoder_inputs(rng, b=2, t=64):
    x = rng.normal(size=(b, t, 8)).astype(np.float32)
    mu = rng.normal(size=(b, t, 16)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.array([t, 37])[:, None]).astype(
        np.float32)[..., None]
    spk = rng.normal(size=(b, 16)).astype(np.float32)
    return x, mask, mu, spk


@pytest.fixture(scope="module")
def decoder_params():
    """One seeded init of the JAX UNet, shared by the UNet and CFM tests
    (the CFM's only parameters are its estimator's)."""
    x, mask, mu, spk = _decoder_inputs(np.random.default_rng(3))
    t = np.array([0.25, 0.7], np.float32)
    init = jax.jit(JaxDecoder(**DEC).init)
    return _jitter(_np(init(jax.random.key(0), x, mask, mu, t, spk)), 3)


def test_decoder_matches_jax(decoder_params):
    """13 Block1Ds and 6 transformer blocks deep, with an odd valid length
    (37) that halves to a ragged mask: 1e-4."""
    x, mask, mu, spk = _decoder_inputs(np.random.default_rng(3))
    t = np.array([0.25, 0.7], np.float32)
    want = jax.jit(JaxDecoder(**DEC).apply)(decoder_params, x, mask, mu, t,
                                            spk)
    port = load_params(Decoder(**DEC, spk_dim=16), decoder_params)
    with torch.no_grad():
        got = port(_t(x), _t(mask), _t(mu), _t(t), _t(spk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def assert_bf16_parity(port, jax_bf16, jax_f32):
    """The port in bf16 compute against JAX in bf16, on the same inputs and
    parameters, relative to JAX's own bf16 - f32 gap.  The frameworks round
    bf16 at different points (a Dense or Conv1d adds its bias inside the
    product's rounding here, after it in JAX; Mish rounds once here), so
    each is its own bf16 approximation of the f32 result: two that round
    independently, each as far from it as JAX's, differ by about sqrt(2)
    times that gap on average and by at most twice it (the triangle
    inequality).  Held: port - JAX within 1.5x JAX's mean gap and 2x its
    max, and the port's own bf16 - f32 gap within 1.25x JAX's, so the
    port's bf16 is no less accurate than the reference's, and at least half
    of it on average, so the port does compute in bf16."""
    gap = np.abs(jax_bf16 - jax_f32)
    err = np.abs(port - jax_bf16)
    own = np.abs(port - jax_f32)
    assert gap.max() > 0
    assert err.mean() <= 1.5 * gap.mean(), (err.mean(), gap.mean())
    assert err.max() <= 2.0 * gap.max(), (err.max(), gap.max())
    assert own.mean() <= 1.25 * gap.mean(), (own.mean(), gap.mean())
    assert own.max() <= 1.25 * gap.max(), (own.max(), gap.max())
    assert own.mean() >= 0.5 * gap.mean(), (own.mean(), gap.mean())


def test_decoder_bf16_matches_jax(decoder_params):
    """bf16 compute, f32 parameters, on both sides: the valid frames held
    against JAX as ``assert_bf16_parity`` states."""
    x, mask, mu, spk = _decoder_inputs(np.random.default_rng(3))
    t = np.array([0.25, 0.7], np.float32)

    def jax_out(dtype):
        return np.asarray(jax.jit(JaxDecoder(**DEC, dtype=dtype).apply)(
            decoder_params, x, mask, mu, t, spk), np.float32)

    port = load_params(Decoder(**DEC, spk_dim=16, dtype=torch.bfloat16),
                       decoder_params)
    with torch.no_grad():
        got = port(_t(x), _t(mask), _t(mu), _t(t), _t(spk))
    valid = mask[..., 0] > 0
    assert_bf16_parity(got.float().numpy()[valid],
                       jax_out(jnp.bfloat16)[valid],
                       jax_out(jnp.float32)[valid])


@pytest.mark.parametrize("solver,steps", [("euler", 3), ("midpoint", 2),
                                          ("ab2", 3)])
def test_cfm_inference_matches_jax(decoder_params, solver, steps):
    """x0 injected on both sides; up to 4 estimator evaluations: 2e-4."""
    rng = np.random.default_rng(4)
    x, mask, mu, spk = _decoder_inputs(rng)
    x0 = (0.667 * rng.normal(size=x.shape)).astype(np.float32)
    params = {"params": {"estimator": decoder_params["params"]}}
    jcfm = JaxCFM(in_channels=24, out_channels=8, spk_embed_dim=16,
                  decoder_channels=(32, 32), decoder_attention_head_dim=16)
    want = jax.jit(lambda p: jcfm.apply(
        p, jnp.asarray(mu), jnp.asarray(mask), jnp.asarray(spk),
        n_timesteps=steps, solver=solver, x0=jnp.asarray(x0),
        method="inference"))(params)
    port = load_params(CFM(24, 8, 16, (32, 32), 16), params)
    got = port.inference(_t(mu), _t(mask), _t(spk), n_timesteps=steps,
                         solver=solver, x0=_t(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# encoder, style encoder, vocoder
# ---------------------------------------------------------------------------


def test_conv1d_resnet_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 40, 12)).astype(np.float32)
    jenc = JaxResnet(out_dim=8, hidden_dim=16)
    params = _jitter(_np(jenc.init(jax.random.key(2), jnp.asarray(x))), 5)
    want = jenc.apply(params, jnp.asarray(x))
    port = load_params(Conv1dResnet(12, 8, 16), params)
    with torch.no_grad():
        got = port(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pooling,norm", [("gru", "masked_group"),
                                          ("attention", "masked_group"),
                                          ("gru", "frozen_batch")])
def test_style_encoder_matches_jax(pooling, norm):
    """Ragged reference lengths: the masked GroupNorm statistics and the
    GRU's frozen state both depend on them.  1e-4 after four normalized
    conv levels and a GRU."""
    rng = np.random.default_rng(6)
    mel = rng.normal(size=(2, 64, 20)).astype(np.float32)
    lengths = np.array([64, 29])
    kw = dict(idim=20, gst_tokens=10, gst_token_dim=32,
              conv_chans=(8, 8, 16, 16), gru_units=16, norm_type=norm,
              pooling=pooling)
    jst = JaxStyle(**kw)
    params = _jitter(_np(jax.jit(jst.init)(jax.random.key(3), mel,
                                           lengths)), 6)
    if norm == "frozen_batch":   # running variances stay positive
        for i in range(4):
            p = params["params"]["ref_enc"][f"norm{i}"]
            p["var"] = np.abs(p["var"]) + 0.5
    want = jax.jit(jst.apply)(params, mel, lengths)
    port = load_params(StyleEncoder(**kw), params)
    with torch.no_grad():
        got = port(_t(mel), torch.tensor(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_hifigan_generator_matches_jax():
    """Odd upsample scale 3 exercises output_padding; 1e-5 on a tanh."""
    rng = np.random.default_rng(7)
    c = rng.normal(size=(1, 12, 10)).astype(np.float32)
    kw = dict(in_channels=10, channels=32, upsample_scales=(2, 3),
              upsample_kernel_sizes=(4, 6))
    jgen = JaxHiFiGAN(**kw)
    params = _jitter(_np(jax.jit(jgen.init)(jax.random.key(4), c)), 7,
                     scale=0.02)
    want = jax.jit(jgen.apply)(params, c)
    port = load_params(HiFiGANGenerator(**kw), params)
    with torch.no_grad():
        got = port(_t(c))
    assert got.shape == (1, 12 * 6, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
