"""The port's CUDA kernels against their plain versions, on the card:
forward (K1-K3) and, through the autograd Functions, backward (K4-K7);
the serving path's batched shapes (a registered style tiled over a
batch, the vocoder tail at batch 8), extraction and the long-form streams
against the CPU's plain route; the Griffin-Lim vocoder, the transcriber
and a vocoder GAN step with the trained weights' K3 synthesis.

Needs an NVIDIA GPU and the CUDA toolkit (the kernels are built with nvcc
at first use); skips without a card.  Imports only torch and the port, so
it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the tests' conftest imports JAX.)
"""

import numpy as np
import pytest
import torch

from serenade_tpu_torch.ops import block1d_cuda, flash_cuda, resblock_cuda


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((2, 2, 75, 32), generator=g, device=dev)
               for _ in range(3))
    mask = torch.ones((2, 75), device=dev)
    mask[1, 40:] = 0
    out = flash_cuda.flash_attention(q, k, v, mask, 0.2)
    ref, _ = flash_cuda.flash_attention_plain(q, k, v, mask, 0.2)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)

    x = torch.randn((2, 70, 20), generator=g, device=dev)
    w = torch.randn((64, 20, 3), generator=g, device=dev) * 0.1
    bias, gamma, beta = (torch.randn((64,), generator=g, device=dev)
                         for _ in range(3))
    m = (torch.arange(70, device=dev)[None, :]
         < torch.tensor([70, 33], device=dev)[:, None]).float()[..., None]
    torch.testing.assert_close(
        block1d_cuda.block1d(x, m, w, bias, gamma, beta),
        block1d_cuda.block1d_plain(x, m, w, bias, gamma, beta),
        rtol=1e-4, atol=1e-4)

    x = torch.randn((1, 300, 32), generator=g, device=dev)
    w1, w2 = (torch.randn((3, 32, 32, 3), generator=g, device=dev) * 0.1
              for _ in range(2))
    b1, b2 = (torch.randn((3, 32), generator=g, device=dev)
              for _ in range(2))
    args = dict(kernel_size=3, dilations=(1, 3, 5))
    torch.testing.assert_close(
        resblock_cuda.resblock_branch(x, w1, b1, w2, b2, **args),
        resblock_cuda.resblock_branch_plain(x, w1, b1, w2, b2, **args),
        rtol=1e-4, atol=1e-4)

    # K4, K5 through the autograd Function against the plain backward
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_cuda.flash_attention(*qkv, mask, 0.2)
    assert out.grad_fn is not None
    cot = torch.randn(out.shape, generator=g, device=dev)
    out.backward(cot)
    _, lse = flash_cuda.flash_attention_plain(q, k, v, mask, 0.2)
    want = flash_cuda.flash_attention_backward_plain(q, k, v, mask, ref, lse,
                                                     cot, 0.2)
    for t, w_ in zip(qkv, want):
        torch.testing.assert_close(t.grad, w_, rtol=1e-4, atol=1e-4)

    # K6, K7 through the autograd Function against the plain backward
    x = torch.randn((2, 70, 20), generator=g, device=dev)
    w = torch.randn((64, 20, 3), generator=g, device=dev) * 0.1
    params = [t.clone().requires_grad_(True) for t in (x, w, bias, gamma,
                                                        beta)]
    out = block1d_cuda.block1d(params[0], m, *params[1:])
    assert out.grad_fn is not None
    cot = torch.randn(out.shape, generator=g, device=dev)
    out.backward(cot)
    want = block1d_cuda.block1d_backward_plain(x, m, w, bias, gamma, beta,
                                               cot)
    for t, w_ in zip(params, want):
        torch.testing.assert_close(t.grad, w_, rtol=1e-4, atol=1e-4)
    assert flash_cuda.dq_launches >= 1 and block1d_cuda.weight_launches >= 1


@pytest.mark.cuda
def test_resblock_kernel_refuses_inputs_that_need_gradients():
    """K3 has no backward (nor has the Pallas kernel): on the card it
    raises rather than return a result that carries no gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    x = torch.randn((1, 64, 32), device=dev, requires_grad=True)
    w = torch.randn((3, 32, 32, 3), device=dev) * 0.1
    b = torch.zeros((3, 32), device=dev)
    args = dict(kernel_size=3, dilations=(1, 3, 5))
    with pytest.raises(RuntimeError, match="no backward"):
        resblock_cuda.resblock_branch(x, w, b, w, b, **args)
    with torch.no_grad():
        assert resblock_cuda.resblock_branch(x, w, b, w, b, **args).shape \
            == x.shape


@pytest.mark.cuda
def test_hopper_flash_forward_at_a_ragged_bf16_shape():
    """K1's wgmma/TMA kernel on the (B, H, T, D) views of a (B, T, H, D)
    buffer at T 736 (not a multiple of 64) with 36 padded keys, against
    the plain version: O and L within 2e-2 of max(1, |ref|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((1, 736, 4, 512), generator=g, device=dev)
               .bfloat16().transpose(1, 2) for _ in range(3))
    mask = (torch.arange(736, device=dev) < 700).float()[None]
    before = flash_cuda.launches
    out, lse = flash_cuda.flash_attention(q, k, v, mask, 512 ** -0.5,
                                          return_lse=True)
    ref, ref_lse = flash_cuda.flash_attention_plain(q, k, v, mask,
                                                    512 ** -0.5)
    assert flash_cuda.launches == before + 1
    for got, want in ((out, ref), (lse, ref_lse)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, want.float().abs().max().item())
    with pytest.raises(ValueError, match="head_dim 256"):
        flash_cuda.flash_attention(q[..., :256], k[..., :256],
                                   v[..., :256], mask, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [1024, 242])
def test_hopper_weight_gradient_at_ragged_bf16_shapes(cin):
    """K7's wgmma kernel (x by TMA at Cin 1024, by cp.async at Cin 242)
    with dy nonzero on padded frames and n_b = 200 (= T), 64 and 1,
    against the plain dW: within 2e-2 of max(1, |ref|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    lengths = [200, 64, 1]
    x = torch.randn((3, 200, cin), generator=g, device=dev).bfloat16()
    dy = torch.randn((3, 200, 512), generator=g, device=dev).bfloat16()
    mask = (torch.arange(200, device=dev)[None, :]
            < torch.tensor(lengths, device=dev)[:, None]).float()[..., None]
    dw = block1d_cuda.block1d_bwd_weight(
        x, torch.tensor(lengths, dtype=torch.int32, device=dev), dy)
    ref = block1d_cuda.block1d_weight_grad_plain(x, mask, dy)
    err = (dw - ref).abs().max().item()
    assert err <= 2e-2 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("c,k", [(256, 11), (128, 7), (64, 3)])
def test_split_tf32_residual_branch_at_ragged_f32_shapes(c, k):
    """K3's split-TF32 kernel at each vocoder width, batch 2 and a T that
    leaves a partial tile, against the plain f32 branch (cuDNN without
    TF32): within 1e-4 of max(1, |ref|), the tolerance a single TF32
    product misses."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((2, 333, c), generator=g, device=dev)
    w1, w2 = (torch.randn((3, c, c, k), generator=g, device=dev)
              / (k * c) ** 0.5 for _ in range(2))
    b1, b2 = (0.1 * torch.randn((3, c), generator=g, device=dev)
              for _ in range(2))
    args = dict(kernel_size=k, dilations=(1, 3, 5))
    assert resblock_cuda.k3_plan(2, 333, c, k, 5, True, torch.float32,
                                 132)["route"] == "tf32"
    out = resblock_cuda.resblock_branch(x, w1, b1, w2, b2, **args)
    ref = resblock_cuda.resblock_branch_plain(x, w1, b1, w2, b2, **args)
    err = (out - ref).abs().max().item()
    assert err <= 1e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [1024, 242])
def test_hopper_block1d_forward_at_ragged_bf16_shapes(cin):
    """K2's wgmma kernel (x by TMA at Cin 1024, by cp.async at Cin 242)
    with lengths inside a tile, at a tile boundary and 1, against the
    plain Block1D: within 2e-2 of max(1, |ref|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    lengths = [200, 131, 64, 1]
    x = torch.randn((4, 200, cin), generator=g, device=dev).bfloat16()
    w = (torch.randn((512, cin, 3), generator=g, device=dev)
         / (3 * cin) ** 0.5).bfloat16()
    bias, gamma, beta = (0.1 * torch.randn((512,), generator=g, device=dev)
                         for _ in range(3))
    mask = (torch.arange(200, device=dev)[None, :]
            < torch.tensor(lengths, device=dev)[:, None]).float()[..., None]
    before = block1d_cuda.launches
    out = block1d_cuda.block1d(x, mask, w, bias, gamma + 1.0, beta)
    ref = block1d_cuda.block1d_plain(x, mask, w, bias, gamma + 1.0, beta)
    assert block1d_cuda.launches == before + 1
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * max(1.0, ref.float().abs().max().item())


@pytest.mark.cuda
def test_hopper_flash_dkv_at_ragged_bf16_shapes():
    """K5's wgmma/TMA kernel at Tq = Tk = 200 (not a multiple of 64) on
    the (B, H, T, D) views of (B, T, H, D) buffers, with key lengths 200,
    96 (key blocks 96-127 and on wholly padded: they store zeros) and 1,
    against the plain backward: within 2e-2 of max(1, |ref|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    q, k, v, cot = (torch.randn((3, 200, 4, 512), generator=g, device=dev)
                    .bfloat16().transpose(1, 2) for _ in range(4))
    mask = (torch.arange(200, device=dev)[None, :]
            < torch.tensor([200, 96, 1], device=dev)[:, None]).float()
    scale = 512 ** -0.5
    out, lse = flash_cuda.flash_attention(q, k, v, mask, scale,
                                          return_lse=True)
    cot, dsum = flash_cuda.flash_bwd_prepare(out, cot, torch.bfloat16)
    before = flash_cuda.dkv_launches
    dk, dv = flash_cuda.flash_bwd_dkv(q, k, v, mask, cot, lse, dsum, scale)
    assert flash_cuda.dkv_launches == before + 1
    _, want_k, want_v = flash_cuda.flash_attention_backward_plain(
        q, k, v, mask, out, lse, cot, scale)
    for got, want in ((dk, want_k), (dv, want_v)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, want.float().abs().max().item())
    # the padded key blocks get exactly zero
    assert not dk[1, :, 96:].any() and not dv[1, :, 96:].any()
    with pytest.raises(ValueError, match="head_dim 256"):
        flash_cuda.flash_bwd_dkv(*(t[..., :256] for t in (q, k, v)), mask,
                                 cot[..., :256], lse, dsum, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [1024, 242])
def test_hopper_block1d_data_gradient_at_ragged_bf16_shapes(cin):
    """K6's wgmma/TMA dx at T 200 (not a multiple of 64) with n_b = 200,
    131, 64 (a multiple of 64) and 1 (its second 128-row tile stores
    zeros), Cin 1024 and 242 (484-byte rows, 4-byte stores), against the
    plain backward: within 2e-2 of max(1, |ref|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    lengths = [200, 131, 64, 1]
    x = torch.randn((4, 200, cin), generator=g, device=dev).bfloat16()
    w = (torch.randn((512, cin, 3), generator=g, device=dev)
         / (3 * cin) ** 0.5).bfloat16()
    bias, gamma, beta = (0.1 * torch.randn((512,), generator=g, device=dev)
                         for _ in range(3))
    cot = torch.randn((4, 200, 512), generator=g, device=dev).bfloat16()
    mask = (torch.arange(200, device=dev)[None, :]
            < torch.tensor(lengths, device=dev)[:, None]).float()[..., None]
    x_, lens, w_, bias_, gamma_, beta_ = block1d_cuda.prepare_forward(
        x, mask, w, bias, gamma + 1.0, beta)
    _, y, stats = block1d_cuda._block1d_cuda(x_, lens, w_, bias_, gamma_,
                                             beta_, 8, 1e-5)
    taps = block1d_cuda.k2_taps(w_)
    before = block1d_cuda.data_launches
    dx, _, (dgam, dbet, db) = block1d_cuda.block1d_bwd_data(
        x_, lens, w_, gamma_, beta_, y, stats, cot)
    assert block1d_cuda.data_launches == before + 1
    want = block1d_cuda.block1d_backward_plain(x, mask, w, bias, gamma + 1.0,
                                               beta, cot)
    for got, ref in zip((dx, db, dgam, dbet), (want[0], *want[2:])):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, ref.float().abs().max().item())
    assert not dx[3, 1:].any() and not dx[2, 64:].any()
    # K6 read the taps K2 made for this weight: none were made again
    assert block1d_cuda.k2_taps(w_) is taps


@pytest.mark.cuda
def test_hopper_flash_dq_at_ragged_bf16_shapes():
    """K4's wgmma/TMA kernel at Tq = Tk = 200 (a ragged last query block
    and key tile) on the (B, H, T, D) views of (B, T, H, D) buffers, with
    key lengths 200, 96 and 1, against the plain backward: within 2e-2 of
    max(1, |ref|); the planner refuses head dim 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    q, k, v, cot = (torch.randn((3, 200, 4, 512), generator=g, device=dev)
                    .bfloat16().transpose(1, 2) for _ in range(4))
    mask = (torch.arange(200, device=dev)[None, :]
            < torch.tensor([200, 96, 1], device=dev)[:, None]).float()
    scale = 512 ** -0.5
    out, lse = flash_cuda.flash_attention(q, k, v, mask, scale,
                                          return_lse=True)
    cot, dsum = flash_cuda.flash_bwd_prepare(out, cot, torch.bfloat16)
    before = flash_cuda.dq_launches
    dq = flash_cuda.flash_bwd_dq(q, k, v, mask, cot, lse, dsum, scale)
    assert flash_cuda.dq_launches == before + 1
    want = flash_cuda.flash_attention_backward_plain(q, k, v, mask, out, lse,
                                                     cot, scale)[0]
    err = (dq.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * max(1.0, want.float().abs().max().item())
    with pytest.raises(ValueError, match="head_dim 256"):
        flash_cuda.flash_bwd_dq(*(t[..., :256] for t in (q, k, v)), mask,
                                cot[..., :256], lse, dsum, scale)


@pytest.mark.cuda
def test_shapes_the_kernels_refuse_take_the_plain_route_on_card():
    """bf16 attention at head dim 32 and a bf16 Block1D at odd Cin run on
    the card through the plain versions (routed by shape, counted, no
    kernel launched), forward and backward, and agree with the same
    computation on the CPU: within 2e-2 of max(1, |ref|), the bf16
    kernels' tolerance (the two devices sum in other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from serenade_tpu_torch.ops.attention import multi_head_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(17)
    q, k, v = (torch.randn((2, 48, 4 * 32), generator=g).bfloat16()
               for _ in range(3))
    mask = torch.ones((2, 48))
    mask[1, 30:] = 0
    x = torch.randn((2, 48, 9), generator=g).bfloat16()
    w = torch.randn((16, 9, 3), generator=g) / 27 ** 0.5
    bias, gamma, beta = (0.1 * torch.randn((16,), generator=g)
                         for _ in range(3))
    bmask = mask[..., None]

    def run(dev):
        qq, ww = (t.detach().to(dev).requires_grad_(True) for t in (q, w))
        att = multi_head_attention(qq, k.to(dev), v.to(dev), num_heads=4,
                                   key_mask=mask.to(dev))
        blk = block1d_cuda.block1d(x.to(dev), bmask.to(dev), ww,
                                   *(p.to(dev) for p in (bias, gamma + 1.0,
                                                         beta)))
        (att.float().square().sum() + blk.float().square().sum()).backward()
        return [t.detach().float().cpu() for t in (att, blk, qq.grad,
                                                   ww.grad)]

    want = run("cpu")
    counts = (flash_cuda.launches, flash_cuda.routed, block1d_cuda.launches,
              block1d_cuda.routed)
    got = run("cuda")
    torch.cuda.synchronize()
    assert (flash_cuda.launches, flash_cuda.routed, block1d_cuda.launches,
            block1d_cuda.routed) == (counts[0], counts[1] + 1, counts[2],
                                     counts[3] + 1)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 2e-2 * max(
            1.0, b.abs().max().item())


# a narrow Serenade whose attention keeps head dim 512, so that in bf16 K1
# and K2 both run (the recipe's head dim; no shape is routed)
NARROW = dict(input_dim=32, output_dim=80, encoder_channels=16,
              encoder_hidden_dim=32, decoder_channels=64, gst_embed_dim=32,
              decoder_attention_head_dim=512, gst_tokens=10,
              gst_conv_chans=(8, 8, 16, 16), gst_gru_units=16)


def _features(rng, frames, with_mel):
    feats = {"hubert": rng.normal(size=(frames, 32)),
             "score": rng.random(frames), "loud": rng.random(frames)}
    if with_mel:
        feats["logmel"] = rng.normal(size=(frames, 80))
    return feats


def _identity_scaler():
    return {"hubert": {"mean": np.zeros(32), "scale": np.ones(32)},
            "score": {"min": 0.0, "max": 1.0},
            "loud": {"min": 0.0, "max": 1.0},
            "logmel": {"mean": np.zeros(80), "scale": np.ones(80)}}


@pytest.mark.cuda
def test_packed_reference_at_batch_4_on_card():
    """A registered style tiled over a batch of 4 (3 requests, two source
    buckets) on the card in f32: equal to the same reference passed per
    request, and within phase 4's 1e-3 of max(1, |mel|) of the CPU's plain
    route on the same weights and noise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from serenade_tpu_torch.api import Converter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(18)
    srcs = [_features(rng, n, False) for n in (150, 100, 70)]
    ref = _features(rng, 100, True)
    x0 = 0.667 * rng.normal(size=(4, 128 + 192, 80))
    out = {}
    for dev in ("cpu", "cuda"):
        conv = Converter(dict(NARROW, dtype="float32"), None,
                         _identity_scaler(), n_timesteps=2, seed=3,
                         device=dev)
        packed = conv.convert_features_batch(
            srcs, packed_ref=conv.pack_reference(ref), pad_batch_pow2=True,
            x0=x0)
        listed = conv.convert_features_batch(srcs, [ref] * 3,
                                             pad_batch_pow2=True, x0=x0)
        out[dev] = (packed, listed)
    for card, listed, cpu in zip(*out["cuda"], out["cpu"][0]):
        assert card.shape == cpu.shape and np.isfinite(card).all()
        assert np.abs(card - listed).max() <= 1e-5
        assert np.abs(card - cpu).max() <= 1e-3 * max(1.0, np.abs(cpu).max())


@pytest.mark.cuda
def test_vocoder_tail_at_batch_8_on_card():
    """``decode_batch_device`` at batch 8 (ragged lengths) through K3
    against the CPU's plain route on the same weights: within one int16
    step (the f32 waveforms differ by about 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from serenade_tpu_torch.vocoder.vocoder import Vocoder

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(19)
    config = {"sampling_rate": 24000, "generator_params": {
        "channels": 128, "upsample_scales": [4, 3],
        "upsample_kernel_sizes": [8, 6]}}
    stats = {"mean": rng.normal(size=80), "scale": rng.uniform(0.5, 2, 80)}
    c = torch.from_numpy(rng.normal(size=(8, 96, 80)).astype(np.float32))
    lengths = [96, 90, 64, 33, 1, 50, 96, 70]
    got = {}
    for dev in ("cpu", "cuda"):
        voc = Vocoder(config, None, stats, take_norm_feat=False, device=dev,
                      seed=4)
        before = resblock_cuda.launches
        got[dev] = voc.decode_batch_device(c.to(dev), lengths).cpu()
        launched = resblock_cuda.launches - before
    assert launched == 6    # 2 upsample stages x 3 residual blocks
    assert got["cuda"].dtype == torch.int16
    diff = (got["cuda"].int() - got["cpu"].int()).abs().max().item()
    assert diff <= 1, diff


@pytest.mark.cuda
def test_viterbi_kernel_matches_plain_on_card():
    """The Viterbi kernel against its plain version (the frame loop) on
    seeded candidates with absent ones (emission 1e6), a batch of 3 rows
    over more than one of the kernel's 256-frame chunks, and one row of
    length 1: identical states, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from serenade_tpu_torch.ops import viterbi_cuda

    rng = np.random.default_rng(23)
    kw = dict(voiced_bias=0.35, transition_octave_cost=6.0, switch_cost=0.4)
    for b, n in ((3, 700), (1, 1)):
        cand = rng.uniform(60.0, 1100.0, (b, n, 5)).astype(np.float32)
        em = rng.uniform(0.0, 1.0, (b, n, 5)).astype(np.float32)
        em[rng.random((b, n, 5)) < 0.3] = 1e6
        em, lf = (torch.from_numpy(a).cuda()
                  for a in (em, np.log2(np.maximum(cand, 1.0))))
        before = viterbi_cuda.launches
        got = viterbi_cuda.viterbi_states(em, lf, **kw)
        assert viterbi_cuda.launches - before == 1
        want = viterbi_cuda.viterbi_states_plain(em, lf, **kw)
        assert torch.equal(got, want)
        assert torch.equal(want.cpu(), viterbi_cuda.viterbi_states_plain(
            em.cpu(), lf.cpu(), **kw))


def _sung(seconds, seed, f0):
    """A harmonic tone with vibrato, a note change and breath noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 24000)) / 24000
    note = np.where(t < seconds / 2, f0, f0 * 2 ** (3 / 12))
    phase = 2 * np.pi * np.cumsum(note * (1 + 0.015 * np.sin(
        2 * np.pi * 5.5 * t))) / 24000
    x = 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase)
    return (x + 0.01 * rng.normal(size=len(t))).astype(np.float32)


@pytest.mark.cuda
def test_card_extraction_matches_cpu():
    """``extract_from_wav_batch`` on the card (the Viterbi kernel, ContentVec
    at 2 layers of 64, seeded) against the CPU's plain route on the same
    weights: log-mel within 1e-4 where within 70 dB of its frame's peak,
    loudness within 1e-4, vuv on 99.5 % of frames and f0 within 1e-3
    relative, the score on 99 % of frames, ContentVec within 1e-4 of
    max(1, |CPU|) (the rules of tests/test_torch_features.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.ops import viterbi_cuda

    cfg = dict(NARROW, input_dim=64, dtype="float32")
    sc = dict(_identity_scaler(), hubert={"mean": np.zeros(64),
                                          "scale": np.ones(64)})
    wavs = [_sung(1.3, 24, 220.0), _sung(1.1, 25, 330.0),
            _sung(2.4, 26, 180.0)]
    out = {}
    for dev in ("cpu", "cuda"):
        conv = Converter(cfg, None, sc, contentvec_config=dict(
            dim=64, num_layers=2, heads=4, ffn_dim=128), n_timesteps=1,
            seed=3, device=dev)
        before = viterbi_cuda.launches
        out[dev] = conv.extract_from_wav_batch(wavs, [24000] * 3)
        launched = viterbi_cuda.launches - before
    assert launched == 2   # two signal groups: 1.1 s, and 1.3 s with 2.4 s
    for card, cpu in zip(out["cuda"], out["cpu"]):
        got = {k: v.cpu().numpy() if torch.is_tensor(v) else v
               for k, v in card.items()}
        want = {k: v.numpy() if torch.is_tensor(v) else v
                for k, v in cpu.items()}
        assert all(got[k].shape == want[k].shape for k in want)
        deep = want["logmel"] < want["logmel"].max(-1, keepdims=True) - 3.5
        diff = np.abs(got["logmel"] - want["logmel"])
        assert diff[~deep].max() <= 1e-4 and diff.max() <= 1e-2
        assert np.abs(got["loud"] - want["loud"]).max() <= 1e-4
        assert (got["vuv"] == want["vuv"]).mean() >= 0.995
        both = (got["vuv"] > 0) & (want["vuv"] > 0)
        assert (np.abs(got["f0"] - want["f0"])[both]
                / want["f0"][both]).max() <= 1e-3
        assert (got["est_lf0_score"] == want["est_lf0_score"]).mean() >= 0.99
        scale = max(1.0, np.abs(want["hubert"]).max())
        assert np.abs(got["hubert"] - want["hubert"]).max() <= 1e-4 * scale


@pytest.mark.cuda
def test_streams_on_card_match_cpu():
    """``convert_features_stream`` (300 frames at chunk 128 / overlap 32)
    and ``convert_wav_stream`` (2 s ramping 64 -> 128, ContentVec at 2
    layers of 64) on the card against the CPU's plain route on the same
    weights at temperature 0: the same segments, mel within phase 4's
    1e-3 of max(1, |mel|) and waveform within 1e-3 of the stream's peak
    |wav| (the narrow random vocoder's output is small); K1, K2, K3 and the
    Viterbi kernel launched, no call routed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.ops import viterbi_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(27)
    sc = dict(_identity_scaler(), hubert={"mean": np.zeros(64),
                                          "scale": np.ones(64)})
    src = {"hubert": rng.normal(size=(300, 64)), "score": rng.random(300),
           "loud": rng.random(300)}
    ref = dict(_features(rng, 100, True), hubert=rng.normal(size=(100, 64)))
    wav = _sung(2.0, 28, 220.0)
    kw = dict(chunk_frames=128, overlap_frames=32)
    out = {}
    for dev in ("cpu", "cuda"):
        conv = Converter(
            dict(NARROW, input_dim=64, dtype="float32"), None, sc,
            vocoder_config={"sampling_rate": 24000, "generator_params": {
                "channels": 32, "upsample_scales": [2, 3],
                "upsample_kernel_sizes": [4, 6]}},
            vocoder_stats={"mean": np.zeros(80), "scale": np.ones(80)},
            contentvec_config=dict(dim=64, num_layers=2, heads=4,
                                   ffn_dim=128),
            n_timesteps=2, temperature=0.0, seed=3, device=dev)
        counts = [m.launches for m in (flash_cuda, block1d_cuda,
                                       resblock_cuda, viterbi_cuda)]
        routed = flash_cuda.routed + block1d_cuda.routed
        out[dev] = (list(conv.convert_features_stream(src, ref, **kw))
                    + list(conv.convert_wav_stream(
                        wav, 24000, ref, first_chunk_frames=64,
                        extract_ctx_frames=32, **kw)))
        launched = [m.launches - c for m, c in zip(
            (flash_cuda, block1d_cuda, resblock_cuda, viterbi_cuda), counts)]
        routed = flash_cuda.routed + block1d_cuda.routed - routed
    assert all(n > 0 for n in launched) and routed == 0
    assert [s for s, _, _ in out["cuda"]] == [s for s, _, _ in out["cpu"]]
    wav_scale = max(np.abs(w_c).max() for _, _, w_c in out["cpu"])
    for (_, mel, w), (_, mel_c, w_c) in zip(out["cuda"], out["cpu"]):
        assert mel.shape == mel_c.shape and np.isfinite(mel).all()
        assert np.abs(mel - mel_c).max() <= 1e-3 * max(1.0,
                                                       np.abs(mel_c).max())
        assert np.abs(w - w_c).max() <= 1e-3 * wav_scale


@pytest.mark.cuda
def test_decode_group_on_card_matches_cpu():
    """One decode group (two sources in one bucket pair with one style,
    --batch-size 2) through ``ssc_decode.decode_core`` on the card and on
    the CPU's plain route, from the same weights and the same noise: mel
    within phase 4's 1e-3 of max(1, |mel|), waveform within 1e-3 of the
    group's peak |wav|, the shifted lf0 equal; K1, K2 and K3 launched, no
    call routed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.bin.ssc_decode import decode_core

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(29)
    sources = {f"EN_s1_song{i}_Control_Group_0": dict(
        _features(rng, t, False), lf0=np.abs(rng.normal(size=t)) * 200)
        for i, t in enumerate((150, 130))}
    refs = {"Breathy": dict(_features(rng, 100, True),
                            f0=np.abs(rng.normal(size=100)) * 300)}
    styles = {u: {"Breathy": "Breathy"} for u in sources}
    out = {}
    for dev in ("cpu", "cuda"):
        conv = Converter(
            dict(NARROW, dtype="float32"), None, _identity_scaler(),
            vocoder_config={"sampling_rate": 24000, "generator_params": {
                "channels": 32, "upsample_scales": [2, 3],
                "upsample_kernel_sizes": [4, 6]}},
            vocoder_stats={"mean": np.zeros(80), "scale": np.ones(80)},
            n_timesteps=2, seed=3, device=dev)
        counts = [m.launches for m in (flash_cuda, block1d_cuda,
                                       resblock_cuda)]
        routed = flash_cuda.routed + block1d_cuda.routed
        noise = np.random.default_rng(30)
        out[dev] = list(decode_core(
            conv, sources, styles, refs, 2,
            noise=lambda b, t: 0.667 * noise.normal(size=(b, t, 80))))
        launched = [m.launches - c for m, c in zip(
            (flash_cuda, block1d_cuda, resblock_cuda), counts)]
        routed = flash_cuda.routed + block1d_cuda.routed - routed
    assert all(n > 0 for n in launched) and routed == 0
    (key, got), = out["cuda"]
    (key_c, want), = out["cpu"]
    assert key == key_c == (192, 128) and len(got) == 2
    wav_scale = max(np.abs(r["wav"]).max() for r in want)
    for r, r_c in zip(got, want):
        assert r["mel"].shape == r_c["mel"].shape
        assert np.abs(r["mel"] - r_c["mel"]).max() <= 1e-3 * max(
            1.0, np.abs(r_c["mel"]).max())
        assert np.abs(r["wav"] - r_c["wav"]).max() <= 1e-3 * wav_scale
        np.testing.assert_array_equal(r["lf0"], r_c["lf0"])


@pytest.mark.cuda
def test_train_loop_on_card_saves_and_resumes_exactly(tmp_path):
    """3 steps of ``SSCTrainer`` on the card (bf16 compute at head dim
    512, the host loader with a prefetch thread), an async save at step 2:
    a fresh trainer resumed from it holds the saved parameters, moments,
    count, step and epochs bit for bit and runs to step 3; the kernels
    launched, no call routed, the losses finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from serenade_tpu_torch.checkpoint import restore_checkpoint
    from serenade_tpu_torch.collaters.ssc import SSCCollater
    from serenade_tpu_torch.datasets.loader import ShardedBatchLoader
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.models.serenade import Serenade
    from serenade_tpu_torch.trainers import (
        SSCTrainer, build_optimizer, build_train_step, create_train_state,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(31)
    items = [{"hubert": rng.normal(size=(t, 32)).astype(np.float32),
              "logmel": rng.normal(size=(t, 80)).astype(np.float32),
              "score": rng.random((t, 1)).astype(np.float32),
              "loud": rng.random((t, 1)).astype(np.float32)}
             for t in (150, 120, 97, 130, 64, 110)]
    config = {"batch_size": 2, "train_max_steps": 3, "log_interval_steps": 1,
              "save_interval_steps": 2, "eval_interval_steps": 100,
              "optimizer_type": "AdamW",
              "optimizer_params": {"lr": 8e-4, "mu_dtype": "bfloat16"},
              "grad_norm": 1.0}
    cfg = dict(NARROW, encoder_channels=80, dropout=0.0, dtype="bfloat16")

    class Writer:
        def __init__(self):
            self.scalars = {}

        def add_scalar(self, key, value, step):
            self.scalars[key, step] = value

    def trainer(outdir):
        model = init_params_(Serenade(**cfg), seed=0).to(dev)
        opt, _ = build_optimizer(config)
        loader = ShardedBatchLoader(items, SSCCollater(), batch_size=2,
                                    seed=1)
        return SSCTrainer(
            config, build_train_step(model, opt, device=dev),
            create_train_state(model, opt), loader, writer=Writer(),
            outdir=str(outdir),
            generator=torch.Generator(device=dev).manual_seed(2))

    counts = (flash_cuda.launches, flash_cuda.dkv_launches,
              block1d_cuda.weight_launches)
    routed = flash_cuda.routed + block1d_cuda.routed
    first = trainer(tmp_path / "a")
    first.run()
    assert all(n > c for n, c in zip(
        (flash_cuda.launches, flash_cuda.dkv_launches,
         block1d_cuda.weight_launches), counts))
    assert flash_cuda.routed + block1d_cuda.routed == routed
    assert all(np.isfinite(v) for v in first._writer.scalars.values())

    path = str(tmp_path / "a" / "checkpoint-2steps")
    saved = restore_checkpoint(path)
    second = trainer(tmp_path / "b")
    second.resume(path)
    assert (second.steps, second.epochs, second.state.step) == (2, 0, 2)
    assert second.state.opt_state["count"] == 2
    for name, p in second.state.params.items():
        assert torch.equal(p.cpu(), saved["params"][name]), name
    for part in ("mu", "nu"):
        for name, t in second.state.opt_state[part].items():
            assert torch.equal(t.cpu(), saved["opt_state"][part][name]), name
    second.run()
    assert second.steps == 3
    assert {s for _, s in second._writer.scalars} == {3}


@pytest.mark.cuda
def test_variant_on_card_matches_plain_and_cpu():
    """The F0-fluctuation variant: K2, K6 and K7 at its first Block1D's
    Cin 244 (x by cp.async, taps padded to 248) against their plain
    versions within 2e-2 (bf16); one f32 ``SerenadeNew`` train step and
    one conversion on the card against the CPU's plain route from the
    same weights, batch, draws, noise and shifts (1e-4 of the metrics,
    1e-3 of max(1, |mel|))."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.models.serenade_new import SerenadeNew
    from serenade_tpu_torch.trainers import (
        build_optimizer, build_train_step, create_train_state,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(30)
    lengths = [200, 131, 64, 1]
    x = torch.randn((4, 200, 244), generator=g, device=dev).bfloat16()
    w = (torch.randn((512, 244, 3), generator=g, device=dev)
         / (3 * 244) ** 0.5).bfloat16()
    bias, gamma, beta = (0.1 * torch.randn((512,), generator=g, device=dev)
                         for _ in range(3))
    cot = torch.randn((4, 200, 512), generator=g, device=dev).bfloat16()
    mask = (torch.arange(200, device=dev)[None, :]
            < torch.tensor(lengths, device=dev)[:, None]).float()[..., None]
    counts = (block1d_cuda.launches, block1d_cuda.data_launches,
              block1d_cuda.weight_launches)
    out = block1d_cuda.block1d(x, mask, w, bias, gamma + 1.0, beta)
    x_, lens, w_, bias_, gamma_, beta_ = block1d_cuda.prepare_forward(
        x, mask, w, bias, gamma + 1.0, beta)
    _, y, stats = block1d_cuda._block1d_cuda(x_, lens, w_, bias_, gamma_,
                                             beta_, 8, 1e-5)
    dx, dy, (dgam, dbet, db) = block1d_cuda.block1d_bwd_data(
        x_, lens, w_, gamma_, beta_, y, stats, cot)
    dw = block1d_cuda.block1d_bwd_weight(x_, lens, dy)
    # K2 twice (the wrapper, then the forward the backward reads), K6, K7
    assert (block1d_cuda.launches, block1d_cuda.data_launches,
            block1d_cuda.weight_launches) == (counts[0] + 2, counts[1] + 1,
                                              counts[2] + 1)
    ref = block1d_cuda.block1d_plain(x, mask, w, bias, gamma + 1.0, beta)
    want = block1d_cuda.block1d_backward_plain(x, mask, w, bias, gamma + 1.0,
                                               beta, cot)
    for got, r in ((out, ref), (dx, want[0]), (dw, want[1]), (db, want[2]),
                   (dgam, want[3]), (dbet, want[4])):
        err = (got.float() - r.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, r.float().abs().max().item())

    cfg = dict(NARROW, encoder_channels=80, dropout=0.0, dtype="float32")
    rng = np.random.default_rng(31)
    b, t = 2, 64
    batch = {"x": rng.normal(size=(b, t, 32)), "lengths": np.array([64, 45]),
             "logmel": rng.normal(size=(b, t, 80)),
             "midi": rng.uniform(size=(b, t, 1)),
             "loud": rng.uniform(size=(b, t, 1)),
             "f0_fluc": 0.05 * rng.normal(size=(b, t, 1))}
    batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v
             for k, v in batch.items()}
    draws = {"frac": 0.3, "start": 0.4, "t": np.array([0.2, 0.7]),
             "z": rng.normal(size=(b, t, 80)), "s1": 17, "s2": 40}
    metrics = []
    for device in ("cpu", dev):
        model = init_params_(SerenadeNew(**cfg), seed=3).to(device)
        opt, _ = build_optimizer({"optimizer_type": "AdamW"})
        step = build_train_step(model, opt, device=device)
        d = {k: torch.as_tensor(v, device=device) if k in ("s1", "s2")
             else torch.as_tensor(v, dtype=torch.float32, device=device)
             for k, v in draws.items()}
        _, m = step(create_train_state(model, opt), batch, None, draws=d)
        metrics.append({k: float(v) for k, v in m.items()})
    for k in metrics[0]:
        assert abs(metrics[0][k] - metrics[1][k]) <= 1e-4 * max(
            1.0, abs(metrics[0][k])), k

    src = {**_features(rng, 150, False),
           "f0_fluc": 0.05 * rng.normal(size=150)}
    ref = {**_features(rng, 100, True),
           "f0_fluc": 0.05 * rng.normal(size=100)}
    x0 = 0.667 * rng.normal(size=(1, 128 + 192, 80))
    mels = [Converter(dict(NARROW, dtype="float32"), None, _identity_scaler(),
                      n_timesteps=2, seed=3, device=device,
                      model_type="SerenadeNew").convert_features(
        src, ref, x0=x0, shifts=[77, 150])[0] for device in ("cpu", dev)]
    assert mels[1].shape == (150, 80) and np.isfinite(mels[1]).all()
    assert np.abs(mels[1] - mels[0]).max() <= 1e-3 * max(
        1.0, np.abs(mels[0]).max())


@pytest.mark.cuda
def test_cheaptrick_and_eval_analysis_on_card_match_cpu():
    """CheapTrick of a sung-like tone and of noise (f64 running sums on
    both) on the card against the CPU, by the CPU tests' rule against JAX:
    the log envelope within 2e-2 where it is within 40 dB of its frame's
    peak, 5e-3 on average within 60 dB; then ``metrics.
    extract_eval_feats_batch`` on both (the Viterbi kernel on the card):
    the voicing on 99.5 % of frames, the mel-cepstrum within 1e-3 on
    average."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from serenade_tpu_torch import metrics
    from serenade_tpu_torch.ops.world import cheaptrick

    sr, hop = 24000, 120
    rng = np.random.default_rng(40)
    n = int(0.8 * sr)
    t = np.arange(n) / sr
    tone = sum(a * np.sin(2 * np.pi * k * 196.0 * t * (1 + 0.01 * np.sin(
        2 * np.pi * 5.5 * t))) for k, a in enumerate((0.3, 0.1, 0.05), 1))
    x = np.stack([tone + 0.01 * rng.normal(size=n),
                  0.05 * rng.normal(size=n)]).astype(np.float32)
    frames = 1 + n // hop
    f0 = np.zeros((2, frames), np.float32)
    f0[0, 20:] = 196.0
    envs = [np.log(cheaptrick(torch.from_numpy(x).to(device),
                              torch.from_numpy(f0).to(device), fs=sr,
                              f0_floor=70.0).cpu().numpy())
            for device in ("cpu", "cuda")]
    err = np.abs(envs[1] - envs[0])
    peak = envs[0].max(axis=-1, keepdims=True)
    near = envs[0] >= peak - 4 * np.log(10.0)
    far = envs[0] >= peak - 6 * np.log(10.0)
    assert err[near].max() <= 2e-2 and err[far].mean() <= 5e-3

    wavs = [x[0], x[1], x[0][: n // 2]]
    cpu, card = (metrics.extract_eval_feats_batch(wavs, sr, device=d)
                 for d in ("cpu", "cuda"))
    for a, b in zip(cpu, card):
        assert (a["vuv"] == b["vuv"]).mean() >= 0.995
        assert np.abs(a["mcep"] - b["mcep"]).mean() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["endpoint", "reflow"])
def test_distill_step_on_card_matches_cpu(mode):
    """One f32 distill step (teacher Euler-3, student 2 steps) on the card
    (K1, K2 and, through the student's backward, K4-K7) against the CPU's
    plain route from the same teacher, batch and draws: the metrics within
    1e-4, the parameters within 1e-5 (phase 6's rule)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.models.serenade import Serenade
    from serenade_tpu_torch.trainers import build_optimizer, create_train_state
    from serenade_tpu_torch.trainers.distill import (
        build_distill_step, distill_trainable_mask, frozen_teacher,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(NARROW, encoder_channels=80, decoder_attention_head_dim=32,
               dropout=0.0, dtype="float32")
    rng = np.random.default_rng(41)
    b, t = 2, 64
    batch = {"x": rng.normal(size=(b, t, 32)), "lengths": np.array([64, 45]),
             "logmel": rng.normal(size=(b, t, 80)),
             "midi": rng.uniform(size=(b, t, 1)),
             "loud": rng.uniform(size=(b, t, 1))}
    batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v
             for k, v in batch.items()}
    draws = {"frac": 0.7, "start": 0.2, "t": np.array([0.3, 0.8]),
             "x0": 0.667 * rng.normal(size=(b, t, 80))}
    sd = init_params_(Serenade(**cfg), seed=3).state_dict()
    config = {"optimizer_type": "AdamW",
              "optimizer_params": {"lr": 1e-4, "eps": 1e-3}, "grad_norm": 1.0}
    out = []
    for device in ("cpu", "cuda"):
        teacher, student = (Serenade(**cfg).to(device) for _ in range(2))
        teacher.load_state_dict(sd)
        student.load_state_dict(sd)
        opt, _ = build_optimizer(
            config, trainable_mask=distill_trainable_mask(student))
        step = build_distill_step(student, frozen_teacher(teacher), opt,
                                  mode=mode, n_teacher_steps=3,
                                  device=device)
        d = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
             for k, v in draws.items()}
        _, m = step(create_train_state(student, opt), batch, None, draws=d)
        out.append(({k: float(v) for k, v in m.items()},
                    {n: p.detach().cpu() for n, p in
                     student.named_parameters()}))
    (m_cpu, p_cpu), (m_dev, p_dev) = out
    for k in m_cpu:
        assert abs(m_cpu[k] - m_dev[k]) <= 1e-4 * max(1.0, abs(m_cpu[k])), k
    for n in p_cpu:
        assert (p_cpu[n] - p_dev[n]).abs().max() <= 1e-5, n


@pytest.mark.cuda
def test_int8_dot_on_card_matches_exact_plain():
    """``int8_matmul`` on the card (``torch._int_mm`` where it takes the
    shape, counted; the plain product where it refuses one, counted as
    routed) equals the exact int32 plain version, and ``int8_dot`` equals
    the same rescale of those sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch._int_mm runs on CUDA")
    from serenade_tpu_torch import quantize as pq

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for (m, k, n), route in (((1536, 512, 2048), "launches"),
                             ((1, 2048, 512), "routed"),
                             ((40, 36, 64), "routed")):
        a, w = (torch.randint(-127, 128, s, generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
                for s in ((m, k), (n, k)))
        pq.launches = pq.routed = 0
        got = pq.int8_matmul(a, w)
        assert getattr(pq, route) == 1 and pq.launches + pq.routed == 1
        assert torch.equal(got, pq.int8_matmul_plain(a, w))
    x = torch.randn((3, 512, 512), generator=g, device=dev)
    qt = pq.quantize_leaf(torch.randn((1024, 512), generator=g, device=dev)
                          / 512 ** 0.5, 0)
    xq, s_x = pq.quantize_rows(x)
    want = (pq.int8_matmul_plain(xq.reshape(-1, 512), qt.q).float()
            .reshape(3, 512, 1024) * s_x * qt.scale.reshape(-1))
    assert torch.equal(pq.int8_dot(x, qt), want)


@pytest.mark.cuda
def test_custom_ops_match_plain_on_card():
    """Each custom op an exported program holds (``ops/custom_ops.py``)
    on CUDA tensors launches its kernel (counted) and agrees with its
    plain version, as the wrappers do; a shape K1 or K2 refuses runs the
    plain version and counts as routed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from serenade_tpu_torch.ops import custom_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((1, 4, 128, 512), generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    mask = torch.ones((1, 128), device=dev)
    mask[0, 100:] = 0
    before = flash_cuda.launches
    out = custom_ops.flash_fwd(q, k, v, mask, 512 ** -0.5)
    assert flash_cuda.launches == before + 1
    ref, _ = flash_cuda.flash_attention_plain(q, k, v, mask, 512 ** -0.5)
    torch.testing.assert_close(out.transpose(1, 2).float(), ref.float(),
                               rtol=2e-2, atol=2e-2)
    routed = flash_cuda.routed
    out = custom_ops.flash_fwd(q[..., :256], k[..., :256], v[..., :256],
                               mask, 256 ** -0.5)   # bf16 head dim 256
    assert flash_cuda.launches == before + 1
    assert flash_cuda.routed == routed + 1
    ref, _ = flash_cuda.flash_attention_plain(
        q[..., :256], k[..., :256], v[..., :256], mask, 256 ** -0.5)
    assert torch.equal(out.transpose(1, 2), ref)

    x = torch.randn((1, 128, 256), generator=g, device=dev,
                    dtype=torch.bfloat16)
    w = (torch.randn((128, 256, 3), generator=g, device=dev) * 0.05).to(
        torch.bfloat16)
    bias, gamma, beta = (torch.randn((128,), generator=g, device=dev)
                         for _ in range(3))
    m = (torch.arange(128, device=dev) < 100).float()[None, :, None]
    before = block1d_cuda.launches
    got = custom_ops.block1d_fwd(x, m, w, bias, gamma, beta, 8, 1e-5)
    assert block1d_cuda.launches == before + 1
    torch.testing.assert_close(
        got.float(), block1d_cuda.block1d_plain(
            x, m, w, bias, gamma, beta).float(), rtol=2e-2, atol=2e-2)
    routed = block1d_cuda.routed
    got = custom_ops.block1d_fwd(x, m, w[:12], bias[:12], gamma[:12],
                                 beta[:12], 4, 1e-5)   # bf16 Cout 12
    assert block1d_cuda.launches == before + 1
    assert block1d_cuda.routed == routed + 1
    assert torch.equal(got, block1d_cuda.block1d_plain(
        x, m, w[:12], bias[:12], gamma[:12], beta[:12], groups=4))

    x = torch.randn((1, 400, 64), generator=g, device=dev)
    w1, w2 = ([torch.randn((64, 64, 7), generator=g, device=dev) * 0.05
               for _ in range(3)] for _ in range(2))
    b1, b2 = ([torch.randn((64,), generator=g, device=dev)
               for _ in range(3)] for _ in range(2))
    before = resblock_cuda.launches
    got = custom_ops.resblock_branch(x, w1, b1, w2, b2, 7, [1, 3, 5], True)
    assert resblock_cuda.launches == before + 1
    torch.testing.assert_close(got, resblock_cuda.resblock_branch_plain(
        x, torch.stack(w1), torch.stack(b1), torch.stack(w2),
        torch.stack(b2), kernel_size=7, dilations=(1, 3, 5)),
        rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_loaded_artifact_launches_the_kernels(tmp_path):
    """A narrow Converter with a HiFiGAN exported for CUDA and loaded: one
    Euler-4 conversion launches K1 and K2 at the live Converter's counts
    (inside the ODE loop's body), K3 once a residual branch, with no call
    routed; its mel equals the live Converter's at the same seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from serenade_tpu_torch import deploy
    from serenade_tpu_torch.api import Converter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(input_dim=32, output_dim=80, encoder_channels=16,
               encoder_hidden_dim=32, decoder_channels=64, gst_embed_dim=32,
               decoder_attention_head_dim=32, gst_tokens=10,
               gst_conv_chans=(8, 8, 16, 16), gst_gru_units=16,
               dtype="float32")
    voc = {"sampling_rate": 24000, "generator_params": {
        "channels": 64, "upsample_scales": [4, 3],
        "upsample_kernel_sizes": [8, 6]}}
    sc = {"hubert": {"mean": np.zeros(32), "scale": np.ones(32)},
          "score": {"min": 0.0, "max": 1.0}, "loud": {"min": 0.0, "max": 1.0},
          "logmel": {"mean": np.zeros(80), "scale": np.ones(80)}}
    conv = Converter(cfg, None, sc, vocoder_config=voc,
                     vocoder_stats={"mean": np.zeros(80),
                                    "scale": np.ones(80)},
                     n_timesteps=4, seed=0, device="cuda")
    deploy.export_converter(conv, str(tmp_path / "art"),
                            buckets=((192, 128),), platforms=("cuda",))
    exp = deploy.load(str(tmp_path / "art"), seed=9)
    rng = np.random.default_rng(2)
    src = {"hubert": rng.normal(size=(150, 32)), "score": rng.random(150),
           "loud": rng.random(150)}
    ref = dict({k: rng.random(100) for k in ("score", "loud")},
               hubert=rng.normal(size=(100, 32)),
               logmel=rng.normal(size=(100, 80)))
    counts = []
    for run in (lambda: exp.convert_features(src, ref),
                lambda: conv.convert_features(src, ref)):
        for mod in (flash_cuda, block1d_cuda, resblock_cuda):
            mod.launches = 0
        flash_cuda.routed = block1d_cuda.routed = 0
        mel = run()[0]
        counts.append((flash_cuda.launches, block1d_cuda.launches,
                       resblock_cuda.launches, flash_cuda.routed,
                       block1d_cuda.routed, mel))
        conv.generator.manual_seed(9)
    (*art, mel_a), (*live, mel_l) = counts
    assert art == live == [24, 52, 6, 0, 0]
    np.testing.assert_allclose(mel_a, mel_l, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k", [(2, 600, 16), (1, 300, 31)])
def test_viterbi_kernel_at_harvest_width(b, n, k):
    """The Viterbi kernel at Harvest's K = 16 (17 states, 256-frame
    chunks) and at its widest K = 31 (32 states, 128-frame chunks) against
    the plain frame loop on seeded candidates with absent ones (emission
    4e6, Harvest's rejected cost): identical states, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from serenade_tpu_torch.ops import viterbi_cuda

    rng = np.random.default_rng(k)
    kw = dict(voiced_bias=0.12, transition_octave_cost=6.0, switch_cost=0.4)
    cand = rng.uniform(80.0, 800.0, (b, n, k)).astype(np.float32)
    em = rng.uniform(0.0, 1.0, (b, n, k)).astype(np.float32)
    em[rng.random((b, n, k)) < 0.5] = 4e6
    em, lf = (torch.from_numpy(a).cuda()
              for a in (em, np.log2(np.maximum(cand, 1.0))))
    before = viterbi_cuda.launches
    got = viterbi_cuda.viterbi_states(em, lf, **kw)
    assert viterbi_cuda.launches - before == 1
    assert torch.equal(got, viterbi_cuda.viterbi_states_plain(em, lf, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("c,k", [(256, 3), (32, 7)])
def test_residual_branch_without_additional_convs(c, k):
    """K3 as SiFiGAN's filter network runs it (one conv a dilation, the
    residual fused) at batch 2 and a ragged T, against the plain branch
    (cuDNN without TF32): within 1e-4 of max(1, |ref|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((2, 1111, c), generator=g, device=dev)
    w = torch.randn((3, c, c, k), generator=g, device=dev) / (k * c) ** 0.5
    b = 0.1 * torch.randn((3, c), generator=g, device=dev)
    args = dict(kernel_size=k, dilations=(1, 3, 5),
                use_additional_convs=False)
    before = resblock_cuda.launches
    out = resblock_cuda.resblock_branch(x, w, b, w, b, **args)
    assert resblock_cuda.launches - before == 1
    ref = resblock_cuda.resblock_branch_plain(x, w, b, w, b, **args)
    assert (out - ref).abs().max().item() <= 1e-4 * max(
        1.0, ref.abs().max().item())


@pytest.mark.cuda
def test_griffin_lim_on_card_matches_cpu():
    """The Griffin-Lim vocoder (32 iterations, f32 DFT products) on the
    card against its CPU run, within 1e-3 of the CPU's peak."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from serenade_tpu_torch.vocoder.griffin_lim import GriffinLimSynth

    g = torch.Generator().manual_seed(16)
    mel = torch.randn((2, 300, 80), generator=g) - 3.0
    synth = GriffinLimSynth()
    with torch.no_grad():
        cpu = synth(mel)
        gpu = synth(mel.cuda()).cpu()
    scale = cpu.abs().amax(dim=1)
    assert ((gpu - cpu).abs().amax(dim=1) <= 1e-3 * scale).all()


@pytest.mark.cuda
def test_transcriber_on_card_matches_cpu():
    """The transcriber (cuDNN's LSTM) at a narrow width on the card: its
    logits within 1e-4 of the CPU's, and the decoder's F0 (the Viterbi
    trellis kernel) giving the CPU's notes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.modules.phoneme_midi.decoding import (
        FramewiseDecoder,
    )
    from serenade_tpu_torch.modules.phoneme_midi.model import (
        TranscriptionModel,
    )

    model = init_params_(TranscriptionModel(40, 64), 3).eval()
    mel = torch.randn((1, 120, 40), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        cpu = model(mel)
        gpu = model.cuda()(mel.cuda()).cpu()
    assert (gpu - cpu).abs().max().item() <= 1e-4
    cfg = dict(sample_rate=16000, win_length=1024, hop_length=160,
               onset_threshold=0.5, offset_threshold=0.5, pitch_sum="median")
    t = np.arange(120 * 160) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    pred = np.full((120, 3), -8.0, np.float32)
    pred[10, 0] = pred[100, 1] = 8.0
    pred[10:101, 2] = 8.0
    want = FramewiseDecoder(cfg, device="cpu").decode(pred, audio=audio)
    got = FramewiseDecoder(cfg, device="cuda").decode(pred, audio=audio)
    assert got[1] == want[1] == [(10, 101)]
    assert abs(got[0][0] - want[0][0]) <= 0.01 and round(got[0][0]) == 57


@pytest.mark.cuda
def test_vocoder_gan_step_and_trained_synthesis_on_card():
    """One HiFiGAN GAN step on the card (the conv backend, no kernel
    launch), every parameter of both networks moved; then the trained
    weights on the fused backend launch K3 and synthesize what the conv
    backend does, within 1e-3 of the peak."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.trainers import vocoder_trainer as vt
    from serenade_tpu_torch.vocoder.hifigan import (
        HiFiGANGenerator, MultiPeriodDiscriminator,
    )

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dict(in_channels=8, channels=32, upsample_scales=(4, 2),
               upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
               resblock_dilations=((1, 3),))
    gen = init_params_(HiFiGANGenerator(**cfg, resblock_backend="conv"), 0)
    disc = init_params_(MultiPeriodDiscriminator(periods=(2, 3)), 1)
    gen.to(dev)
    disc.to(dev)
    before = {k: v.clone() for k, v in list(gen.state_dict().items())
              + list(disc.state_dict().items())}
    gopt, dopt = vt.adamw_chain(2e-3), vt.adamw_chain(2e-3)
    state = vt.create_vocoder_state(gen, disc, gopt, dopt)
    step = vt.build_vocoder_train_step(gen, disc, gopt, dopt)
    g = torch.Generator(device=dev).manual_seed(5)
    batch = {"mel": torch.randn((2, 16, 8), generator=g, device=dev),
             "wav": 0.1 * torch.randn((2, 128, 1), generator=g, device=dev)}
    k3 = resblock_cuda.launches
    state, metrics = step(state, batch)
    assert resblock_cuda.launches == k3
    assert all(torch.isfinite(v) for v in metrics.values())
    after = dict(list(gen.state_dict().items())
                 + list(disc.state_dict().items()))
    assert all(not torch.equal(before[k], after[k]) for k in before)
    fused = HiFiGANGenerator(**cfg).to(dev).eval()
    fused.load_state_dict(gen.state_dict())
    mel = torch.randn((1, 50, 8), generator=g, device=dev)
    with torch.no_grad():
        want = gen.eval()(mel)
        got = fused(mel)
    assert resblock_cuda.launches > k3
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()
