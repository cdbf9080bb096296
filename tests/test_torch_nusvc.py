"""NUSVC (``models/nusvc.py``) against the JAX package's, on the CPU, at
the small width ``tests/test_nusvc.py`` builds it at: the three losses
with JAX's own flow-time and noise draws, the gradients of ``loss``
against ``jax.grad``, Euler inference from JAX's noise, a padded length
in the batch; in f32 (1e-4 of max(1, |ref|), losses 1e-5 relative) and
the inference in bf16 compute with f32 parameters (the bf16 rule of
``tests/test_torch_models.py::assert_bf16_parity``).  Then the flash
route at NUSVC's head dim 256.  Each test compiles only the JAX programs
it reads (pytest-xdist may send a file's tests to several workers)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from serenade_tpu.models.nusvc import NUSVC as JaxNUSVC

from serenade_tpu_torch.config import resolve
from serenade_tpu_torch.convert import load_params, state_dict_from_flax
from serenade_tpu_torch.models.nusvc import NUSVC
from serenade_tpu_torch.ops import flash_cuda
from serenade_tpu_torch.ops.attention import multi_head_attention

from test_torch_models import assert_bf16_parity

SMALL = dict(input_dim=12, output_dim=8, encoder_channels=12,
             decoder_channels=16, gst_embed_dim=16,
             decoder_attention_head_dim=16)
B, T, LENGTHS = 2, 64, (64, 55)
TR, REF_LENGTHS = 48, (48, 40)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def case():
    """Inputs from a numpy seed, and the parameters: random leaves of JAX's
    init shapes (``jax.eval_shape``: nothing compiled), norm scales near
    1, the rest ~ N(0, 1/fan_in)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, 12)).astype(np.float32)
    mel = rng.normal(size=(B, T, 8)).astype(np.float32)
    ref = rng.normal(size=(B, TR, 8)).astype(np.float32)
    lengths = np.array(LENGTHS, np.int32)
    model = JaxNUSVC(**SMALL, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0)}, x, lengths, mel, rng=jax.random.key(1),
        deterministic=True))

    def leaf(path, s):
        if str(path[-1].key) in ("scale", "g"):
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 10
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    return dict(x=x, mel=mel, ref=ref, lengths=lengths, params=params,
                ref_lengths=np.array(REF_LENGTHS, np.int32))


def _draws(key, b, t, c):
    """JAX's CFM draws from the loss's key (``cfm.py`` compute_loss)."""
    kt, kz = jax.random.split(key)
    tt = jax.random.uniform(kt, (b, 1, 1), dtype=jnp.float32)
    z = jax.random.normal(kz, (b, t, c), dtype=jnp.float32)
    return _t(np.asarray(tt).reshape(b)), _t(np.asarray(z))


def _port(case, dtype="float32"):
    return load_params(NUSVC(**SMALL, dtype=dtype), case["params"])


def _jax_losses(case, dtype, key):
    model = JaxNUSVC(**SMALL, dtype=dtype)

    def loss(params):
        out = model.apply(params, case["x"], case["lengths"], case["mel"],
                          rng=key, deterministic=True)
        return out["loss"], out

    return jax.jit(jax.value_and_grad(loss, has_aux=True))(case["params"])


def _port_losses(port, case, key):
    t, z = _draws(key, B, T, 8)
    return port(_t(case["x"]), torch.tensor(case["lengths"]),
                _t(case["mel"]), t=t, z=z, train=False)


def test_registered_under_model():
    assert resolve("model", "NUSVC") is NUSVC


def test_losses_and_gradients_match_jax(case):
    key = jax.random.key(5)
    (_, want), grads = _jax_losses(case, jnp.float32, key)
    port = _port(case)
    got = _port_losses(port, case, key)
    for name in ("cfm_loss", "prior_loss", "loss"):
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   rtol=1e-5, err_msg=name)
    got["loss"].backward()
    # the bridge is linear: JAX's gradient tree maps onto the port's
    ref = state_dict_from_flax(port, jax.tree_util.tree_map(np.asarray,
                                                            grads))
    for name, p in port.named_parameters():
        want_g = ref[name].numpy()
        tol = 1e-4 * max(1.0, float(np.abs(want_g).max()))
        np.testing.assert_allclose(p.grad.numpy(), want_g, rtol=0, atol=tol,
                                   err_msg=name)


def _jax_inference(case, dtype, key, steps=3):
    model = JaxNUSVC(**SMALL, dtype=dtype)
    return np.asarray(jax.jit(lambda p: model.apply(
        p, case["x"], case["lengths"], case["ref"], case["ref_lengths"],
        rng=key, n_timesteps=steps, method="inference"))(case["params"]),
        np.float32)


def _port_inference(port, case, key, steps=3):
    # JAX's noise: normal(key) x temperature, handed in as x0
    x0 = 0.667 * np.asarray(jax.random.normal(key, (B, T, 8), jnp.float32))
    return port.inference(_t(case["x"]), torch.tensor(case["lengths"]),
                          _t(case["ref"]), torch.tensor(case["ref_lengths"]),
                          n_timesteps=steps, x0=_t(x0)).float().numpy()


INFER_KEY = 9


@pytest.fixture(scope="module")
def jax_f32_mel(case):
    """JAX's f32 inference, which the f32 and bf16 tests both read."""
    return _jax_inference(case, jnp.float32, jax.random.key(INFER_KEY))


def test_inference_matches_jax(case, jax_f32_mel):
    """Euler, 3 steps, a padded source and reference row: 1e-4."""
    want = jax_f32_mel
    got = _port_inference(_port(case), case, jax.random.key(INFER_KEY))
    assert got.shape == (B, T, 8)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


def test_bf16_matches_jax(case, jax_f32_mel):
    """bf16 compute, f32 parameters, on both sides: the inference mel's
    valid frames under the rule (the encoder, the style encoder and three
    UNet evaluations in bf16)."""
    key = jax.random.key(INFER_KEY)
    got = _port_inference(_port(case, "bfloat16"), case, key)
    assert np.isfinite(got).all()
    valid = np.arange(T)[None, :] < case["lengths"][:, None]
    assert_bf16_parity(got[valid],
                       _jax_inference(case, jnp.bfloat16, key)[valid],
                       jax_f32_mel[valid])


def test_bf16_style_encoder_is_finite_on_the_cpu(case):
    """The GST's stride-2 convs in bf16 on the CPU (oneDNN's bf16 conv2d in
    torch 2.13 returned NaN for some calls of these shapes, varying from
    call to call; the port now sums them in f32 there): finite, and the
    same on every call."""
    port = _port(case, "bfloat16")
    ref, lengths = _t(case["ref"]), torch.tensor(case["ref_lengths"])
    with torch.no_grad():
        first = port.gst(ref, lengths)
        for _ in range(4):
            again = port.gst(ref, lengths)
            assert torch.isfinite(again).all()
            assert torch.equal(again, first)


def test_flash_takes_head_dim_256_in_bf16():
    """NUSVC's self-attention (4 heads x 256 in bf16) is one the Hopper
    kernels take, so it counts in no routed call; 128 stays refused."""
    assert flash_cuda.flash_supported(512, 512, 256, torch.bfloat16)
    assert not flash_cuda.flash_supported(512, 512, 128, torch.bfloat16)
    assert not flash_cuda.flash_supported(1, 50, 256, torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, 4 * 256), generator=g).bfloat16()
               for _ in range(3))
    before = flash_cuda.routed
    out = multi_head_attention(q, k, v, num_heads=4)
    assert flash_cuda.routed == before and out.shape == (1, 8, 1024)
    multi_head_attention(q[..., :512], k[..., :512], v[..., :512],
                         num_heads=4)
    assert flash_cuda.routed == before + 1
