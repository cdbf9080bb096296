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
import torch.nn.functional as F

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
    """Square self-attention at head dim 16 (no flash kernel takes it in
    f32) and the GST token attention (tq=1) both take the plain path; the
    first counts as routed."""
    rng = np.random.default_rng(1)
    b, heads, d = 2, 4, 16
    q = rng.normal(size=(b, tq, heads * d)).astype(np.float32)
    k, v = (rng.normal(size=(b, tk, heads * d)).astype(np.float32)
            for _ in range(2))
    mask = _prefix_mask([tk, tk - 20], tk)
    before = flash_cuda.routed
    got = multi_head_attention(_t(q), _t(k), _t(v), num_heads=heads,
                               key_mask=_t(mask))
    assert flash_cuda.routed == before + (tq == tk)
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


def test_k3_split_tf32_keeps_f32_accuracy_where_one_tf32_product_does_not():
    """Why K3's kernel takes three tensor-core products: with TF32 emulated
    here (operands rounded to 10 mantissa bits as ``cvt.rna.tf32`` does,
    products summed in f32), a branch at C 64, k 11, dilations 1, 3, 5
    whose convs take a_lo w_hi + a_hi w_lo + a_hi w_hi stays within K3's
    1e-4 of max(1, |ref|) of the plain f32 branch, and one whose convs take
    a_hi w_hi alone does not."""
    from serenade_tpu_torch.models.layers import conv1d

    rng = np.random.default_rng(64)
    c, k, t, dils = 64, 11, 256, (1, 3, 5)
    x = _t(rng.normal(size=(1, t, c)))
    w1, w2 = (_t(rng.normal(size=(3, c, c, k)) / np.sqrt(k * c))
              for _ in range(2))
    b1, b2 = (_t(0.1 * rng.normal(size=(3, c))) for _ in range(2))
    ref = resblock_cuda.resblock_branch_plain(x, w1, b1, w2, b2,
                                              kernel_size=k, dilations=dils)

    def branch(products):
        def conv(a, w, b, d):
            ah, al = resblock_cuda.tf32_split(a)
            wh, wl = resblock_cuda.tf32_split(w)
            parts = {"lo hi": (al, wh), "hi lo": (ah, wl), "hi hi": (ah, wh)}
            out = b.expand(a.shape[0], a.shape[1], c)
            for name in products:
                aa, ww = parts[name]
                out = out + conv1d(aa, ww, None, dilation=d,
                                   padding=((k - 1) // 2 * d,) * 2)
            return out

        h = x
        for i, d in enumerate(dils):
            o = conv(F.leaky_relu(h, 0.1), w1[i], b1[i], d)
            h = h + conv(F.leaky_relu(o, 0.1), w2[i], b2[i], 1)
        return h

    scale = max(1.0, ref.abs().max().item())
    split = (branch(("lo hi", "hi lo", "hi hi")) - ref).abs().max().item()
    single = (branch(("hi hi",)) - ref).abs().max().item()
    assert split / scale <= 1e-4 < single / scale
    # the parts are TF32 values (low 13 bits clear) and hi + lo keeps all
    # but about 2^-22 of each weight
    hi, lo = resblock_cuda.tf32_split(w1)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - w1).abs() <= 2.0 ** -21 * w1.abs()).all()


# ---------------------------------------------------------------------------
# K4, K5: flash backward; K6, K7: Block1D backward (the training slice)
# ---------------------------------------------------------------------------


def test_k4_k5_flash_backward_plain_matches_jax_pallas():
    """dq, dk, dv of the port's plain backward against jax.grad through the
    Pallas kernels in interpret mode (32-row blocks, so T = 75 leaves a
    ragged tile), with the second row's keys padded past 40.  f32, 2e-5:
    summation order only."""
    rng = np.random.default_rng(20)
    b, h, t, d = 2, 2, 75, 32
    q, k, v, cot = (rng.normal(size=(b, h, t, d)).astype(np.float32)
                    for _ in range(4))
    mask = _prefix_mask([75, 40], t)
    scale = d ** -0.5

    def loss(q, k, v):
        out = flash_attention_pallas(q, k, v, jnp.asarray(mask), scale,
                                     32, 32, True)
        return jnp.sum(out * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, lse = flash_cuda.flash_attention_plain(_t(q), _t(k), _t(v),
                                                _t(mask), scale)
    got = flash_cuda.flash_attention_backward_plain(
        _t(q), _t(k), _t(v), _t(mask), out, lse, _t(cot), scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL,
                                   err_msg=name)
    # the autograd Function's CPU branch runs the same backward
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    torch.sum(flash_cuda.flash_attention(qt, kt, vt, _t(mask), scale)
              * _t(cot)).backward()
    for g, a in zip(got, (qt, kt, vt)):
        torch.testing.assert_close(a.grad, g, rtol=1e-6, atol=1e-6)
    assert flash_cuda.dq_launches == flash_cuda.dkv_launches == 0


@pytest.mark.parametrize("cin,cout", [(20, 64), (128, 128)])
def test_k6_k7_block1d_backward_plain_matches_jax_pallas(cin, cout):
    """dx, dW, dbias, dgamma, dbeta of the port's plain backward against
    jax.grad through the fused Pallas Block1D in interpret mode, prefix
    masks of lengths 64 and 41.  The Pallas kernels take single-pass f32
    statistics where the plain version takes two passes: 1e-4, as for K2."""
    rng = np.random.default_rng(cin + 30)
    b, t = 2, 64
    x = rng.normal(size=(b, t, cin)).astype(np.float32)
    mask = _prefix_mask([64, 41], t)[..., None]
    kernel = (rng.normal(size=(3, cin, cout)) / np.sqrt(3 * cin)).astype(
        np.float32)
    bias, beta = (0.1 * rng.normal(size=(cout,)).astype(np.float32)
                  for _ in range(2))
    gamma = (1 + 0.1 * rng.normal(size=(cout,))).astype(np.float32)
    cot = rng.normal(size=(b, t, cout)).astype(np.float32)

    def loss(x, kernel, bias, gamma, beta):
        out = fused_block1d(x, jnp.asarray(mask), kernel, bias, gamma, beta,
                            groups=8, interpret=True)
        return jnp.sum(out * cot)

    jx, jw, jb, jg, jbeta = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, kernel, bias, gamma, beta)))
    weight = np.transpose(kernel, (2, 1, 0))   # (Cout, Cin, 3)
    dx, dw, db, dg, dbeta = block1d_cuda.block1d_backward_plain(
        _t(x), _t(mask), _t(weight), _t(bias), _t(gamma), _t(beta), _t(cot))
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jx), **tol)
    np.testing.assert_allclose(dw.numpy(),
                               np.transpose(np.asarray(jw), (2, 1, 0)), **tol)
    for got, want in ((db, jb), (dg, jg), (dbeta, jbeta)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    assert not np.abs(dx.numpy()[1, 41:]).any()   # padded frames get none
    assert block1d_cuda.data_launches == block1d_cuda.weight_launches == 0


def test_backward_functions_pass_gradcheck_on_cpu():
    """Both autograd Functions' CPU branches in float64 at tiny shapes: the
    plain backward is the exact gradient of the plain forward (padded keys
    and padded frames included)."""
    gen = torch.Generator().manual_seed(5)

    def rand(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)

    key_mask = torch.ones((2, 6), dtype=torch.float64)
    key_mask[1, 4:] = 0
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_cuda.flash_attention(q, k, v, key_mask, 0.5),
        (rand(2, 2, 6, 4), rand(2, 2, 6, 4), rand(2, 2, 6, 4)))
    mask = torch.from_numpy(_prefix_mask([7, 4], 7)[..., None]).double()
    assert torch.autograd.gradcheck(
        lambda x, w, b, g, be: block1d_cuda.block1d(x, mask, w, b, g, be,
                                                    groups=2),
        (rand(2, 7, 3), rand(8, 3, 3), rand(8), rand(8), rand(8)))


# ---------------------------------------------------------------------------
# The build and the launch plans of the Hopper kernels (K1, K7)
# ---------------------------------------------------------------------------

SM_COUNT = 132          # an H100 SXM
SMEM_LIMIT = 232448     # dynamic shared memory a block may use on it
TRAIN_K7_SHAPES = [(16, 512, 1024, 512), (16, 512, 242, 512),
                   (16, 256, 512, 512), (16, 256, 1024, 512)]


def test_editing_any_header_renames_every_library(tmp_path, monkeypatch):
    """A library's name hashes its source and every ``csrc/*.cuh``: after
    an edit to any header, no kernel can load a stale build."""
    import shutil

    from serenade_tpu_torch.ops import _cuda

    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC_DIR, csrc)
    headers = sorted(p.name for p in csrc.glob("*.cuh"))
    assert {"common.cuh", "hopper.cuh"} <= set(headers)
    before = {n: _cuda._target(n, csrc) for n in _cuda.SOURCES}
    assert before == {n: _cuda._target(n) for n in _cuda.SOURCES}
    for header in headers:
        path = csrc / header
        original = path.read_bytes()
        path.write_bytes(original + b"\n// edited\n")
        after = {n: _cuda._target(n, csrc) for n in _cuda.SOURCES}
        assert all(after[n] != before[n] for n in _cuda.SOURCES), header
        path.write_bytes(original)
    assert {n: _cuda._target(n, csrc) for n in _cuda.SOURCES} == before
    # the libraries link libcuda for the TMA descriptors
    monkeypatch.setattr(_cuda, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    assert "-lcuda" in _cuda._command("flash_fwd", tmp_path / "lib.so")


@pytest.mark.parametrize("b,t,cin,cout", TRAIN_K7_SHAPES
                         + [(3, 130, 96, 128), (1, 64, 2, 8), (2, 700, 1000,
                                                              520),
                            (9, 4096, 64, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k7_plan_covers_every_tile_once(b, t, cin, cout, dtype):
    plan = block1d_cuda.k7_plan(b, t, cin, cout, dtype, SM_COUNT)
    bco, bci = block1d_cuda.K7_TILE[dtype]
    gx, gy, splits = plan["grid"]
    # every (Cout, Cin) output tile has a column of CTAs, none past the end
    assert gx * bco >= cout > (gx - 1) * bco
    assert gy * bci >= cin > (gy - 1) * bci
    # the split bounds the wrapper hands the kernel, one more than splits
    bounds = plan["bounds"]
    assert splits == plan["splits"] == len(bounds) - 1 >= 1
    assert splits <= block1d_cuda.K7_MAX_SPLITS
    assert list(plan["bounds_c"]) == list(bounds)
    # every (sample, 64-row tile) of every sample's time range belongs to
    # exactly one split
    tps = -(-t // block1d_cuda.K7_ROWS)
    seen = [i for first, last in zip(bounds, bounds[1:])
            for i in range(first, last)]
    assert sorted(seen) == list(range(b * tps)) == list(range(
        plan["time_tiles"]))
    rows = {(i // tps, (i % tps) * 64 + r) for i in seen for r in range(64)
            if (i % tps) * 64 + r < t}
    assert rows == {(s, u) for s in range(b) for u in range(t)}
    assert plan["smem_bytes"] <= SMEM_LIMIT
    if dtype == torch.bfloat16:
        # one CTA per SM: the split fills at most one wave
        assert gx * gy * splits <= max(SM_COUNT, gx * gy)
        assert plan["x_loader"] == ("tma" if cin % 8 == 0 else "cp.async")


def test_k7_plan_takes_cin_242_by_cp_async_and_refuses_what_it_cannot_load():
    loaders = [block1d_cuda.k7_plan(*s, torch.bfloat16, SM_COUNT)["x_loader"]
               for s in TRAIN_K7_SHAPES]
    assert loaders == ["tma", "cp.async", "tma", "tma"]
    with pytest.raises(ValueError, match="Cin 241 must be even"):
        block1d_cuda.k7_plan(16, 512, 241, 512, torch.bfloat16, SM_COUNT)
    with pytest.raises(ValueError, match="Cout 500 must be a multiple of 8"):
        block1d_cuda.k7_plan(16, 512, 242, 500, torch.bfloat16, SM_COUNT)
    # f32 takes any shape
    assert block1d_cuda.k7_plan(2, 70, 21, 63, torch.float32, SM_COUNT)


@pytest.mark.parametrize("t,ctas", [(1536, 96), (1024, 64), (768, 48),
                                    (736, 48), (512, 32)])
def test_k1_plan_fill_and_shared_memory(t, ctas):
    plan = flash_cuda.k1_plan(1, 4, t, 512, torch.bfloat16, SM_COUNT)
    assert plan["grid"] == (-(-t // 64), 4, 1)
    assert plan["ctas"] == plan["sms_used"] == ctas
    assert plan["threads"] == 384
    assert plan["smem_bytes"] <= SMEM_LIMIT
    f32 = flash_cuda.k1_plan(1, 4, t, 512, torch.float32, SM_COUNT)
    assert f32["smem_bytes"] <= SMEM_LIMIT
    # the train step's forward fills the card several times over
    assert flash_cuda.k1_plan(16, 4, 512, 512, torch.bfloat16,
                              SM_COUNT)["ctas"] == 512


@pytest.mark.parametrize("d", [32, 128, 384])
def test_k1_refuses_a_bf16_head_dim_it_does_not_take(d):
    with pytest.raises(ValueError, match=f"head_dim {d}"):
        flash_cuda.k1_plan(1, 4, 256, d, torch.bfloat16, SM_COUNT)
    # the f32 kernel keeps every head dim up to 512
    assert flash_cuda.k1_plan(1, 4, 256, d, torch.float32, SM_COUNT)


# ---------------------------------------------------------------------------
# K3 and K2 on Hopper: the launch planners and the weight caches
# ---------------------------------------------------------------------------

VOCODER_LEVELS = [(8192, 256), (49152, 128), (245760, 64)]


@pytest.mark.parametrize("b,t,c", [(1, t, c) for t, c in VOCODER_LEVELS]
                         + [(1, 300, 32), (2, 150, 128), (2, 333, 256),
                            (1, 1200, 16), (3, 100, 64)])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_k3_plan_covers_every_output_once(b, t, c, k):
    """Each conv launch of each dilation stage: its row tiles cover [0, T)
    of every sample exactly once, its two consumers all C columns, its
    window the tile and both halos, within the kernel's shared memory and
    ring depth."""
    for d in (1, 3, 5):
        plan = resblock_cuda.k3_plan(b, t, c, k, d, True, torch.float32,
                                     SM_COUNT)
        assert plan["route"] == "tf32" and len(plan["convs"]) == 2
        for conv, dil in zip(plan["convs"], (d, 1)):
            bm, (tiles, batch) = conv["bm"], conv["grid"]
            assert batch == b and conv["ctas"] == b * tiles
            assert bm == 64 * conv["mb"] * (2 // conv["ns"])
            rows = [r for i in range(tiles) for r in range(i * bm,
                                                           (i + 1) * bm)
                    if r < t]
            assert rows == list(range(t))
            assert conv["wn"] * conv["ns"] == c
            # accumulators within the 168 registers of a 384-thread CTA
            assert conv["mb"] * conv["wn"] // 2 <= 64
            assert conv["rows"] == bm + 2 * ((k - 1) // 2 * dil)
            assert 2 <= conv["stages"] <= 8
            assert conv["smem_bytes"] == resblock_cuda.tf32_smem_bytes(
                c, conv["rows"], conv["stages"])
            assert conv["smem_bytes"] <= SMEM_LIMIT - 1024


@pytest.mark.parametrize("t,c,bm,ctas", [(8192, 256, 64, 128),
                                         (49152, 128, 128, 384),
                                         (245760, 64, 256, 960)])
def test_k3_plan_fills_the_card_at_every_vocoder_level(t, c, bm, ctas):
    """A 1024-frame conversion's three levels: at C 256 the consumers split
    the columns so that T 8192 gives 128 CTAs of 64 rows for 132 SMs (one
    of 128 rows would give 64); C 128 and 64 give several waves."""
    for k in (3, 7, 11):
        for d in (1, 3, 5):
            conv1, conv2 = resblock_cuda.k3_plan(
                1, t, c, k, d, True, torch.float32, SM_COUNT)["convs"]
            assert conv1["bm"] == conv2["bm"] == bm
            assert conv1["ctas"] == ctas
            assert conv1["ns"] == (2 if c == 256 else 1)
    assert resblock_cuda.k3_plan(1, 8192, 256, 11, 5, True, torch.float32,
                                 SM_COUNT)["convs"][0]["ctas"] <= SM_COUNT


def test_k3_plan_routes_what_the_tf32_kernel_does_not_take_to_fma():
    """bf16, and f32 at widths other than 16, 32, 64, 128 and 256, run the
    FMA kernel (a stage a launch); a width neither kernel takes raises; a
    branch without additional convs has one conv a stage."""
    for c, dtype in ((256, torch.bfloat16), (8, torch.float32),
                     (512, torch.float32)):
        plan = resblock_cuda.k3_plan(1, 1000, c, 11, 3, True, dtype,
                                     SM_COUNT)
        assert plan["route"] == "fma"
        assert plan["tile_rows"] == resblock_cuda.tile_rows(c, 11, 3, True)
        assert plan["smem_bytes"] <= resblock_cuda.SMEM_BUDGET
    for c in (24, 96):
        with pytest.raises(ValueError, match=f"C {c}"):
            resblock_cuda.k3_plan(1, 1000, c, 3, 1, True, torch.float32,
                                  SM_COUNT)
    plan = resblock_cuda.k3_plan(1, 1000, 64, 3, 1, False, torch.float32,
                                 SM_COUNT)
    assert plan["route"] == "tf32" and len(plan["convs"]) == 1


K2_SHAPES = [(1, 1536, 1024, 512), (1, 1536, 242, 512), (1, 1536, 512, 512),
             (1, 768, 512, 512), (1, 768, 1024, 512), (1, 736, 1024, 512),
             (16, 512, 1024, 512), (16, 512, 242, 512), (16, 256, 512, 512),
             (3, 200, 1024, 512), (2, 150, 242, 64)]


@pytest.mark.parametrize("b,t,cin,cout", K2_SHAPES)
def test_k2_plan_covers_every_tile_once(b, t, cin, cout):
    plan = block1d_cuda.k2_plan(b, t, cin, cout, torch.bfloat16, SM_COUNT)
    gx, gy, gb = plan["grid"]
    bn = 2 * plan["wn"]
    assert plan["wn"] in block1d_cuda.K2_WN and gb == b
    rows = [r for i in range(gx) for r in range(64 * i, 64 * i + 64)
            if r < t]
    cols = [co for j in range(gy) for co in range(bn * j, bn * j + bn)
            if co < cout]
    assert rows == list(range(t)) and cols == list(range(cout))
    assert plan["ctas"] == gx * gy * gb
    assert (block1d_cuda.K2_MIN_STAGES[plan["x_loader"]] <= plan["stages"]
            <= block1d_cuda.K2_MAX_STAGES)
    assert plan["smem_bytes"] == (plan["stages"]
                                  * block1d_cuda.k2_stage_bytes(plan["wn"])
                                  + 1024)
    assert plan["smem_bytes"] <= SMEM_LIMIT - 4096
    assert plan["x_loader"] == ("tma" if cin % 8 == 0 else "cp.async")


@pytest.mark.parametrize("b,t,wn,ctas", [(1, 1536, 64, 96), (1, 768, 32, 96),
                                         (1, 736, 32, 96),
                                         (16, 512, 64, 512),
                                         (16, 256, 64, 256)])
def test_k2_plan_fill_at_the_main_shapes(b, t, wn, ctas):
    """Batch 1 at T 1536 takes 96 CTAs of 64 x 128; at T 768 tiles of
    64 x 128 would give 48 CTAs, so it takes 96 of 64 x 64; the train
    step's batch 16 fills the card several times over."""
    for cin in (242, 512, 1024):
        plan = block1d_cuda.k2_plan(b, t, cin, 512, torch.bfloat16, SM_COUNT)
        assert (plan["wn"], plan["ctas"]) == (wn, ctas)


def test_k2_plan_refuses_what_the_hopper_kernel_cannot_load():
    with pytest.raises(ValueError, match="Cin 241 must be even"):
        block1d_cuda.k2_plan(1, 1536, 241, 512, torch.bfloat16, SM_COUNT)
    # f32 runs the FMA kernel at any shape, with no ring
    f32 = block1d_cuda.k2_plan(2, 70, 21, 64, torch.float32, SM_COUNT)
    assert f32["grid"] == (2, 1, 2) and f32["smem_bytes"] == 0
    # room for two stages only: enough for TMA loads, not for cp.async ones
    two = 2 * block1d_cuda.k2_stage_bytes(64) + 1024
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(block1d_cuda, "K2_SMEM_LIMIT", two)
        block1d_cuda.k2_plan.cache_clear()
        try:
            plan = block1d_cuda.k2_plan(1, 1536, 1024, 512, torch.bfloat16,
                                        SM_COUNT)
            assert (plan["wn"], plan["stages"]) == (64, 2)
            with pytest.raises(ValueError, match="2 stages of cp.async"):
                block1d_cuda.k2_plan(1, 1536, 242, 512, torch.bfloat16,
                                     SM_COUNT)
        finally:
            block1d_cuda.k2_plan.cache_clear()


def test_k2_taps_lay_out_each_tap_k_major_and_padded():
    rng = np.random.default_rng(5)
    w = _t(rng.normal(size=(64, 242, 3)))
    taps = block1d_cuda.k2_taps(w)
    assert taps.shape == (3, 64, 248) and taps.dtype == torch.bfloat16
    for j in range(3):
        assert torch.equal(taps[j, :, :242], w[:, :, j].bfloat16())
    assert not taps[:, :, 242:].any()


def test_version_cache_makes_once_per_version_and_drops_freed_tensors():
    """The kernels' weight operands are made once per version of the
    weights: reused while the tensor is unchanged, made again after an
    in-place update, dropped when the tensor is freed."""
    import gc

    from serenade_tpu_torch.ops import _cuda

    made = []
    cache = _cuda.VersionCache(lambda a, b: made.append(1) or a + b)
    a, b = torch.ones(4), torch.zeros(4)
    first = cache(a, b)
    assert cache(a, b) is first and len(made) == 1
    a.add_(1)                               # bumps a's version counter
    assert torch.equal(cache(a, b), a + b) and len(made) == 2
    assert len(cache) == 1
    del a
    gc.collect()
    assert len(cache) == 0
    # the residual block hands the wrapper its parameters themselves, per
    # dilation, so K3's split weights are made once per version of them
    from serenade_tpu_torch.vocoder import layers

    block = HiFiGANResidualBlock(3, 16, (1, 3, 5))
    x = torch.randn(1, 40, 16)
    seen = []

    def spy(x, *params, **kw):
        seen.append(params)
        return resblock_cuda.resblock_branch(x, *params, **kw)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "resblock_branch", spy)
        for p in block.parameters():
            p.normal_(0.0, 0.1)
        out1 = block(x)
        out2 = block(x)
        assert torch.equal(out1, out2)
        assert all(a is b for pa, pb in zip(*seen) for a, b in zip(pa, pb))
        ops = resblock_cuda.tf32_operands(*seen[0])
        assert resblock_cuda.tf32_operands(*seen[1]) is ops
        w1 = torch.stack([block.conv1_0.weight, block.conv1_1.weight,
                          block.conv1_2.weight])
        assert torch.equal(ops[0][:, 0, :, 0],
                           resblock_cuda.tf32_round(w1.permute(0, 3, 1, 2)))
        assert torch.equal(ops[1][0], block.conv1_0.bias)
        block.conv1_0.weight.mul_(2.0)
        assert not torch.equal(block(x), out1)
        assert resblock_cuda.tf32_operands(*seen[2]) is not ops


K6_SHAPES = TRAIN_K7_SHAPES + [(3, 200, 1024, 512), (2, 150, 242, 512),
                               (4, 200, 242, 512), (1, 64, 2, 8)]


@pytest.mark.parametrize("b,t,cin,cout", K6_SHAPES)
def test_k6_plan_covers_every_tile_once(b, t, cin, cout):
    """Every (128-row tile, Cin tile) of dx has one CTA, the ring fits the
    card's shared memory, and the taps hold every weight row a tile reads."""
    plan = block1d_cuda.k6_plan(b, t, cin, cout, torch.bfloat16, SM_COUNT)
    gx, gy, gb = plan["grid"]
    bn = plan["bn"]
    assert bn in block1d_cuda.K6_BN and gb == b
    rows = [r for i in range(gx) for r in range(128 * i, 128 * i + 128)
            if r < t]
    cols = [o for j in range(gy) for o in range(bn * j, bn * j + bn)
            if o < cin]
    assert rows == list(range(t)) and cols == list(range(cin))
    assert (gx - 1) * 128 < t and (gy - 1) * bn < cin
    assert plan["ctas"] == gx * gy * gb
    assert 2 <= plan["stages"] <= block1d_cuda.K6_MAX_STAGES
    assert plan["smem_bytes"] == (plan["stages"]
                                  * block1d_cuda.k6_stage_bytes(bn) + 1024)
    assert plan["smem_bytes"] <= SMEM_LIMIT - 1024
    # a stage: one tap's 128-row dy box, then BN / 64 boxes of 64 Cout rows
    # x 64 Cin of K2's taps, 128 bytes a row
    assert block1d_cuda.k6_stage_bytes(bn) == 128 * 128 + bn // 64 * 64 * 128


@pytest.mark.parametrize("t,cin,bn,ctas", [(512, 1024, 256, 256),
                                           (512, 242, 128, 128),
                                           (256, 512, 128, 128),
                                           (256, 1024, 256, 128)])
def test_k6_plan_fill_at_the_train_step_shapes(t, cin, bn, ctas):
    """128 x 256 tiles where they fill the card (two waves at Cin 1024, T
    512); 128 x 128 where 128 x 256 would leave half of it idle."""
    plan = block1d_cuda.k6_plan(16, t, cin, 512, torch.bfloat16, SM_COUNT)
    assert (plan["bn"], plan["ctas"]) == (bn, ctas)
    assert plan["stages"] == (4 if bn == 256 else 7)


def test_k6_plan_refuses_what_the_hopper_kernel_cannot_take():
    with pytest.raises(ValueError, match="Cin 241 must be even"):
        block1d_cuda.k6_plan(16, 512, 241, 512, torch.bfloat16, SM_COUNT)
    with pytest.raises(ValueError, match="Cout 500 must be a multiple of 8"):
        block1d_cuda.k6_plan(16, 512, 242, 500, torch.bfloat16, SM_COUNT)
    # f32 runs the FMA kernel on 64 x 64 tiles at any shape, with no ring
    f32 = block1d_cuda.k6_plan(2, 70, 21, 63, torch.float32, SM_COUNT)
    assert f32["grid"] == (2, 1, 2)
    assert (f32["bn"], f32["stages"], f32["smem_bytes"]) == (0, 0, 0)


def test_k2_taps_read_transposed_give_k6s_dx_and_are_made_once_per_version():
    """K6 reads K2's taps, (3, Cout, Cin8) with Cin contiguous, as its B
    MN-major: step j pairs dy[s - 1 + j] with tap 2 - j, and
    sum_j dy[s - 1 + j] taps[2 - j] is the plain version's dx; the taps are
    made once per weight version (the forward's serve the backward), again
    after an in-place update."""
    rng = np.random.default_rng(7)
    w = _t(rng.normal(size=(64, 242, 3)))
    taps = block1d_cuda.k2_taps(w)
    assert taps.shape == (3, 64, 248) and taps.is_contiguous()
    assert block1d_cuda.k2_taps(w) is taps
    b, t = 2, 40
    mask = _t(_prefix_mask([40, 23], t)[..., None])
    dy = (_t(rng.normal(size=(b, t, 64))) * mask).bfloat16().float()
    want = F.conv1d(dy.transpose(1, 2),
                    w.bfloat16().float().flip(2).transpose(0, 1),
                    padding=1).transpose(1, 2)
    dyp = F.pad(dy, (0, 0, 1, 1))
    got = sum(dyp[:, j:j + t] @ taps[2 - j].float() for j in range(3))
    torch.testing.assert_close(got[..., :242], want, rtol=1e-5, atol=1e-5)
    assert not got[..., 242:].any()
    with torch.no_grad():
        w.mul_(2.0)
    again = block1d_cuda.k2_taps(w)
    assert again is not taps
    assert torch.equal(again[2, :, :242], w[:, :, 2].bfloat16())


@pytest.mark.parametrize("b,h,tq,tk", [(16, 4, 512, 512), (16, 4, 256, 256),
                                       (2, 4, 200, 200), (3, 4, 200, 200),
                                       (1, 4, 75, 200)])
def test_k5_plan_covers_every_key_block_once(b, h, tq, tk):
    """One CTA per 32 keys of each (b, h), every query tile visited by
    each, and K, V, one Q and one dO tile and the P and dS tiles within
    the card's shared memory."""
    plan = flash_cuda.k5_plan(b, h, tq, tk, 512, torch.bfloat16, SM_COUNT)
    gx, gh, gb = plan["grid"]
    keys, queries = plan["keys"], plan["query_tile"]
    assert (keys, queries, plan["stages"]) == (32, 64, 1)
    assert (gh, gb) == (h, b) and plan["threads"] == 384
    seen = [t for i in range(gx) for t in range(keys * i, keys * i + keys)
            if t < tk]
    assert seen == list(range(tk)) and (gx - 1) * keys < tk
    assert [q for i in range(plan["query_tiles"])
            for q in range(queries * i, queries * i + queries)
            if q < tq] == list(range(tq))
    assert plan["ctas"] == gx * h * b
    assert plan["sms_used"] == min(plan["ctas"], SM_COUNT)
    tiles = 2 * 64 * 512 * 2 + 2 * 32 * 512 * 2 + 3 * 32 * 64 * 2
    assert plan["smem_bytes"] == tiles + 1024 <= SMEM_LIMIT - 1024
    f32 = flash_cuda.k5_plan(b, h, tq, tk, 128, torch.float32, SM_COUNT)
    assert f32["grid"] == (-(-tk // 16), h, b)
    assert f32["smem_bytes"] <= SMEM_LIMIT


@pytest.mark.parametrize("d", [64, 128, 384, 576])
def test_k5_refuses_a_bf16_head_dim_it_does_not_take(d):
    with pytest.raises(ValueError, match=f"head_dim {d}"):
        flash_cuda.k5_plan(16, 4, 512, 512, d, torch.bfloat16, SM_COUNT)


# ---------------------------------------------------------------------------
# K4 on Hopper: the launch planner; the route by shape around the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,tq,tk", [(16, 4, 512, 512), (16, 4, 256, 256),
                                       (2, 4, 200, 200), (3, 4, 200, 200),
                                       (1, 4, 75, 200)])
def test_k4_plan_covers_every_query_row_once(b, h, tq, tk):
    """One CTA per 64 query rows of each (b, h), walking every 32-key tile,
    with Q and dO resident, five half-tile slots of K or V and the dS tile
    within the card's shared memory."""
    plan = flash_cuda.k4_plan(b, h, tq, tk, 512, torch.bfloat16, SM_COUNT)
    gx, gh, gb = plan["grid"]
    rows, keys = plan["query_rows"], plan["key_tile"]
    assert (rows, keys, plan["slots"]) == (64, 32, 5)
    assert (gh, gb) == (h, b) and plan["threads"] == 384
    seen = [q for i in range(gx) for q in range(rows * i, rows * i + rows)
            if q < tq]
    assert seen == list(range(tq)) and (gx - 1) * rows < tq
    assert [t for i in range(plan["key_tiles"])
            for t in range(keys * i, keys * i + keys)
            if t < tk] == list(range(tk))
    assert plan["ctas"] == gx * h * b
    assert plan["sms_used"] == min(plan["ctas"], SM_COUNT)
    # Q and dO, five 32-key x 256-column halves, the 64-row dS tile
    tiles = 2 * 64 * 512 * 2 + 5 * 32 * 256 * 2 + 64 * 128
    assert plan["smem_bytes"] == tiles + 1024 <= SMEM_LIMIT - 1024
    f32 = flash_cuda.k4_plan(b, h, tq, tk, 128, torch.float32, SM_COUNT)
    assert f32["grid"] == (-(-tq // 16), h, b)
    assert f32["smem_bytes"] <= SMEM_LIMIT


@pytest.mark.parametrize("d", [64, 128, 384, 576])
def test_k4_refuses_a_bf16_head_dim_it_does_not_take(d):
    with pytest.raises(ValueError, match=f"head_dim {d}"):
        flash_cuda.k4_plan(16, 4, 512, 512, d, torch.bfloat16, SM_COUNT)
    if d <= 512:
        assert flash_cuda.k4_plan(16, 4, 512, 512, d, torch.float32,
                                  SM_COUNT)


@pytest.mark.parametrize("kernel", ["k1", "k4", "k5"])
def test_head_dim_256_plans(kernel):
    """NUSVC's head dim 256 (B 16 x 4 heads x T 512, and batch 1 at T
    1024): the grid of head dim 512, the shared memory of the same layout
    at half the columns (K1: Q 32 KB, two stages of K and V 16 KB each, the
    S exchange 32 KB; K4: Q and dO 32 KB each, five 8 KB half tiles, dS;
    K5: Q and dO 32 KB each, K and V 16 KB each, P and dS)."""
    plan = getattr(flash_cuda, f"{kernel}_plan")
    args = ((16, 4, 512, 256) if kernel == "k1" else (16, 4, 512, 512, 256))
    p256 = plan(*args, torch.bfloat16, SM_COUNT)
    p512 = plan(*args[:-1], 512, torch.bfloat16, SM_COUNT)
    assert p256["grid"] == p512["grid"] and p256["threads"] == 384
    smem = {"k1": 64 * 256 * 2 + 2 * 2 * 32 * 256 * 2 + 32 * 1024,
            "k4": 2 * 64 * 256 * 2 + 5 * 32 * 128 * 2 + 64 * 128,
            "k5": 2 * 64 * 256 * 2 + 2 * 32 * 256 * 2 + 3 * 32 * 64 * 2}
    assert p256["smem_bytes"] == smem[kernel] + 1024 < p512["smem_bytes"]
    if kernel == "k1":
        assert plan(1, 4, 1024, 256, torch.bfloat16,
                    SM_COUNT)["ctas"] == 64


def _takes(plan, *args):
    try:
        plan(*args)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_supported_agrees_with_the_planners(dtype):
    """A square shape the predicate accepts is one that K1, K4 and K5 all
    plan, and one it rejects is refused by at least one of them."""
    for t in (1, 75, 200, 512):
        for d in (16, 32, 48, 64, 128, 256, 512, 576, 1024):
            takes = (_takes(flash_cuda.k1_plan, 2, 4, t, d, dtype, SM_COUNT)
                     and _takes(flash_cuda.k4_plan, 2, 4, t, t, d, dtype,
                                SM_COUNT)
                     and _takes(flash_cuda.k5_plan, 2, 4, t, t, d, dtype,
                                SM_COUNT))
            assert flash_cuda.flash_supported(t, t, d, dtype) == takes, (t, d)
    # the Hopper kernels' bf16 route is for square self-attention only
    assert not flash_cuda.flash_supported(1, 50, 512, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block1d_cuda_supported_agrees_with_the_planners(dtype):
    """A shape the predicate accepts is one that K2, K6 and K7 all plan and
    whose parameters the wrappers' checks take; one it rejects is refused
    by at least one of them."""
    def takes(b, t, cin, cout, groups):
        x = torch.empty((b, t, cin), dtype=dtype, device="meta")
        w = torch.empty((cout, cin, 3), dtype=dtype, device="meta")
        p = torch.empty((cout,), device="meta")
        return (_takes(block1d_cuda._check_params, x, w,
                       {"bias": p, "gamma": p, "beta": p}, groups)
                and all(_takes(plan, b, t, cin, cout, dtype, SM_COUNT)
                        for plan in (block1d_cuda.k2_plan,
                                     block1d_cuda.k6_plan,
                                     block1d_cuda.k7_plan)))

    for cin in (1, 2, 5, 20, 242, 1024):
        for cout, groups in ((8, 8), (12, 4), (20, 4), (24, 8), (36, 6),
                             (64, 8), (512, 8), (510, 6)):
            assert block1d_cuda.block1d_cuda_supported(
                2, 64, cin, cout, groups, dtype) == takes(
                    2, 64, cin, cout, groups), (cin, cout, groups)


def test_multi_head_attention_routes_a_refused_shape_by_shape():
    """bf16 attention at head dim 32 and f32 at head dim 16 take the plain
    version, differentiable by autograd, and count as routed; shapes the
    kernels take go through the flash wrapper and do not; non-square
    attention is not counted."""
    rng = np.random.default_rng(7)

    def run(tq, tk, heads, d, dtype):
        q = _t(rng.normal(size=(2, tq, heads * d))).to(dtype)
        k, v = (_t(rng.normal(size=(2, tk, heads * d))).to(dtype)
                for _ in range(2))
        q.requires_grad_(True)
        mask = _t(_prefix_mask([tk, tk - 3], tk))
        before = flash_cuda.routed
        out = multi_head_attention(q, k, v, num_heads=heads, key_mask=mask)
        routed = flash_cuda.routed - before
        qh = q.reshape(2, tq, heads, d).transpose(1, 2)
        kh, vh = (x.reshape(2, tk, heads, d).transpose(1, 2) for x in (k, v))
        want, _ = flash_cuda.flash_attention_plain(qh, kh, vh, mask,
                                                   d ** -0.5)
        torch.testing.assert_close(
            out, want.transpose(1, 2).reshape(2, tq, heads * d), rtol=0,
            atol=0)
        out.float().sum().backward()
        assert q.grad is not None and bool(q.grad.abs().amax() > 0)
        return routed

    assert run(24, 24, 2, 32, torch.bfloat16) == 1
    assert run(24, 24, 2, 16, torch.float32) == 1
    assert run(24, 24, 2, 32, torch.float32) == 0
    assert run(24, 24, 1, 512, torch.bfloat16) == 0
    assert run(1, 24, 2, 32, torch.bfloat16) == 0
    assert flash_cuda.launches == 0


def test_block1d_routes_a_refused_shape_by_shape():
    """Odd Cin or Cout not a multiple of 8 in bf16, Cout not a multiple of
    4 in f32: the plain Block1D, differentiable by autograd, counted as
    routed; shapes the kernels take go through Block1DFunction."""
    gen = torch.Generator().manual_seed(8)

    def run(cin, cout, groups, dtype):
        x = torch.randn((2, 16, cin), generator=gen).to(dtype)
        w = torch.randn((cout, cin, 3), generator=gen, requires_grad=True)
        bias, gamma, beta = (torch.randn((cout,), generator=gen)
                             for _ in range(3))
        mask = torch.from_numpy(_prefix_mask([16, 11], 16)[..., None])
        before = block1d_cuda.routed
        out = block1d_cuda.block1d(x, mask, w, bias, gamma, beta,
                                   groups=groups)
        routed = block1d_cuda.routed - before
        want = block1d_cuda.block1d_plain(x, mask, w, bias, gamma, beta,
                                          groups=groups)
        torch.testing.assert_close(out, want, rtol=0, atol=0)
        out.float().sum().backward()
        assert bool(w.grad.abs().amax() > 0)
        return routed

    assert run(5, 16, 8, torch.bfloat16) == 1
    assert run(6, 12, 4, torch.bfloat16) == 1
    assert run(6, 6, 2, torch.float32) == 1
    assert run(6, 16, 8, torch.bfloat16) == 0
    assert run(5, 12, 4, torch.float32) == 0
    assert block1d_cuda.launches == 0
