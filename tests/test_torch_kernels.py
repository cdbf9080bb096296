"""The port's three kernel modules against the JAX package, on the CPU.

Each kernel wrapper of ``serenade_tpu_torch`` runs its plain PyTorch
version for CPU tensors; here that version and the module around it are
held against the JAX function (its Pallas kernel in interpret mode and its
plain XLA path) on the same numpy inputs and the same parameters.  All in
f32; the tests pin JAX's matmul precision to float32 (conftest), so the
tolerances cover summation order only, except where stated.  The CUDA
kernels themselves are held against the same plain versions on the card
(``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from serenade_tpu.models import unet as jax_unet
from serenade_tpu.ops.attention import _xla_attention
from serenade_tpu.ops.attention import multi_head_attention as jax_mha
from serenade_tpu.ops.block1d_pallas import fused_block1d
from serenade_tpu.ops.flash_pallas import (
    _flash_forward,
    flash_attention_pallas,
)
from serenade_tpu.ops.resblock_pallas import resblock_branch_pallas
from serenade_tpu.vocoder.layers import HiFiGANResidualBlock as JaxResBlock

from serenade_tpu_torch.convert import load_params
from serenade_tpu_torch.models.unet import Block1D
from serenade_tpu_torch.ops import block1d_cuda, flash_cuda, resblock_cuda
from serenade_tpu_torch.ops.attention import multi_head_attention
from serenade_tpu_torch.vocoder.layers import HiFiGANResidualBlock

F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _prefix_mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)


# ---------------------------------------------------------------------------
# K1: flash attention
# ---------------------------------------------------------------------------


def test_k1_flash_matches_jax_pallas_and_xla():
    """T = 75 is no multiple of the 32-row tiles, and the second row's keys
    are padded past 40: the ragged tail and the -1e30 key bias both act."""
    rng = np.random.default_rng(0)
    b, h, t, d = 2, 2, 75, 32
    q, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32)
               for _ in range(3))
    mask = _prefix_mask([75, 40], t)
    scale = d ** -0.5
    out, lse = flash_cuda.flash_attention(_t(q), _t(k), _t(v), _t(mask),
                                          scale, return_lse=True)
    j_out = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(mask), scale,
                                   32, 32, True)
    _, j_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), scale, 32, 32, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:, :, :t, 0],
                               **F32_TOL)
    x_out = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(mask), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(x_out), **F32_TOL)


@pytest.mark.parametrize("tq,tk", [(75, 75), (1, 50)])
def test_k1_multi_head_attention_matches_jax(tq, tk):
    """Square self-attention goes through the flash wrapper, the GST token
    attention (tq=1) through the plain einsum path."""
    rng = np.random.default_rng(1)
    b, heads, d = 2, 4, 16
    q = rng.normal(size=(b, tq, heads * d)).astype(np.float32)
    k, v = (rng.normal(size=(b, tk, heads * d)).astype(np.float32)
            for _ in range(2))
    mask = _prefix_mask([tk, tk - 20], tk)
    got = multi_head_attention(_t(q), _t(k), _t(v), num_heads=heads,
                               key_mask=_t(mask))
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   num_heads=heads, key_mask=jnp.asarray(mask), backend="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_kernel_wrappers_count_only_cuda_launches():
    rng = np.random.default_rng(2)
    q = _t(rng.normal(size=(1, 1, 8, 32)))
    before = flash_cuda.launches
    flash_cuda.flash_attention(q, q, q, None, 0.5)
    assert flash_cuda.launches == before


# ---------------------------------------------------------------------------
# K2: fused Block1D
# ---------------------------------------------------------------------------


def _block1d_case(cin, cout, seed):
    rng = np.random.default_rng(seed)
    b, t = 2, 64
    x = rng.normal(size=(b, t, cin)).astype(np.float32)
    mask = _prefix_mask([64, 41], t)[..., None]
    jblock = jax_unet.Block1D(cout)
    params = _np(jblock.init(jax.random.key(seed), jnp.asarray(x),
                             jnp.asarray(mask)))
    # non-trivial norm affine and conv bias
    p = params["params"]
    p["conv"]["bias"] = rng.normal(size=(cout,)).astype(np.float32) * 0.1
    p["norm"]["scale"] = 1 + 0.1 * rng.normal(size=(cout,)).astype(np.float32)
    p["norm"]["bias"] = 0.1 * rng.normal(size=(cout,)).astype(np.float32)
    port = load_params(Block1D(cin, cout), params)
    with torch.no_grad():
        got = port(_t(x), _t(mask)).numpy()
    return x, mask, jblock, params, got


@pytest.mark.parametrize("cin,cout", [(20, 64), (128, 128)])
def test_k2_block1d_matches_jax_unfused(cin, cout):
    x, mask, jblock, params, got = _block1d_case(cin, cout, cin)
    want = jblock.apply(params, jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("cin,cout", [(20, 64), (128, 128)])
def test_k2_block1d_matches_jax_fused_kernel(cin, cout):
    """The Pallas kernel takes single-pass statistics (E[y^2] - mu^2) where
    the port's plain version takes two passes: 1e-4 allows for that."""
    x, mask, _, params, got = _block1d_case(cin, cout, cin + 1)
    p = params["params"]
    want = fused_block1d(jnp.asarray(x), jnp.asarray(mask),
                         jnp.asarray(p["conv"]["kernel"]),
                         jnp.asarray(p["conv"]["bias"]),
                         jnp.asarray(p["norm"]["scale"]),
                         jnp.asarray(p["norm"]["bias"]), groups=8,
                         interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_k2_padding_is_ignored():
    """Garbage past each row's length changes nothing: the conv input is
    masked and the statistics cover valid frames only."""
    x, mask, _, params, got = _block1d_case(20, 64, 5)
    x2 = x + (1 - mask) * 100.0
    port = load_params(Block1D(20, 64), params)
    with torch.no_grad():
        got2 = port(_t(x2), _t(mask)).numpy()
    np.testing.assert_allclose(got2, got, rtol=1e-6, atol=1e-6)
    assert block1d_cuda.launches == 0


# ---------------------------------------------------------------------------
# K3: HiFiGAN residual branch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,k", [(32, 3), (32, 11), (128, 3), (128, 11)])
def test_k3_branch_matches_jax(c, k):
    """Port branch vs the JAX conv backend (1e-5) and the Pallas branch
    kernel in interpret mode, whose C < 128 lane padding and 64-row tiles
    put sequence edges inside tiles."""
    rng = np.random.default_rng(c + k)
    dils = (1, 3, 5)
    x = (rng.normal(size=(1, 100, c)) * 0.5).astype(np.float32)
    jblock = JaxResBlock(kernel_size=k, channels=c, dilations=dils)
    params = _np(jblock.init(jax.random.key(k), jnp.asarray(x)))
    p = params["params"]
    for name in p:
        p[name]["bias"] = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    port = load_params(HiFiGANResidualBlock(k, c, dils), params)
    with torch.no_grad():
        got = port(_t(x)).numpy()
    want = jblock.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)

    def stack(prefix, leaf):
        return jnp.stack([p[f"{prefix}_{i}"][leaf] for i in range(3)])

    fused = resblock_branch_pallas(
        jnp.asarray(x), stack("conv1", "kernel"), stack("conv1", "bias"),
        stack("conv2", "kernel"), stack("conv2", "bias"), kernel_size=k,
        dilations=dils, block_t=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(fused), rtol=1e-5, atol=1e-5)
    assert resblock_cuda.launches == 0


@pytest.mark.parametrize("c", [8, 16, 32, 64, 128, 256])
def test_k3_stage_tiles_fit_shared_memory(c):
    """Every stage of a generator branch (C up to 256, the first level of a
    512-channel generator) gets a time tile whose windows fit the kernel's
    shared-memory budget, and C that the 8 x 8 thread tiles cannot split
    is refused."""
    for k in (3, 7, 11):
        for d in (1, 3, 5):
            bt = resblock_cuda.tile_rows(c, k, d, True)
            assert 0 < bt <= resblock_cuda.MAX_TILE
            assert (resblock_cuda.smem_bytes(c, k, d, True, bt)
                    <= resblock_cuda.SMEM_BUDGET)
    assert resblock_cuda._pass_shape(c) is not None
    assert resblock_cuda._pass_shape(c + 4) is None
