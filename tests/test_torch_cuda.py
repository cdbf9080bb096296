"""The port's CUDA kernels against their plain versions, on the card:
forward (K1-K3) and, through the autograd Functions, backward (K4-K7).

Needs an NVIDIA GPU and the CUDA toolkit (the kernels are built with nvcc
at first use); skips without a card.  Imports only torch and the port, so
it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the tests' conftest imports JAX.)
"""

import pytest
import torch

from serenade_tpu_torch.ops import block1d_cuda, flash_cuda, resblock_cuda


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
