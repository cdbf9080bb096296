"""The forward kernels K1, K2 and K3 as ``torch.library`` custom ops, so an
exported program (``deploy.py``) can hold them.

The kernels are launched through ``ctypes`` with raw pointers, which
``torch.export`` cannot trace.  While a program is being exported
(``torch.compiler.is_exporting()``), the wrappers ``flash_cuda.
flash_attention``, ``block1d_cuda.block1d`` and ``resblock_cuda.
resblock_branch`` call these ops instead of launching; the live path
keeps calling the kernels directly, without the ops' dispatch cost.  Each
op has

- a CUDA implementation: the hand-written kernel, through the wrapper's
  own launch function, so its launch counter counts it;
- a CPU implementation: the kernel's plain version;
- a fake: the output's shape and dtype, for tracing.

A trace runs none of them, so the route is chosen when the program runs:
the wrappers hand K1 and K2 every shape while exporting, and the ops send
a shape the kernel refuses to its plain version and count it in the
wrapper module's ``routed``, on every call, as the live wrappers do.

Importing this module registers them (``serenade::flash_fwd``,
``serenade::block1d_fwd``, ``serenade::resblock_branch``); an artifact's
loader imports it, and nothing of the model code.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from serenade_tpu_torch.ops import block1d_cuda, flash_cuda, resblock_cuda

# -- K1: flash attention forward --------------------------------------------


@torch.library.custom_op("serenade::flash_fwd", mutates_args=(),
                         device_types="cuda")
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_mask: Optional[torch.Tensor],
              scale: float) -> torch.Tensor:
    """Attention over ``(B, H, T, D)`` heads; returns ``(B, Tq, H, D)``,
    the layout K1 writes (the caller's head merge is a reshape)."""
    if not _flash_takes(q, k):
        return _flash_plain(q, k, v, key_mask, scale)
    out, _ = flash_cuda._flash_cuda(q, k, v, key_mask, scale)
    return out.transpose(1, 2)


def _flash_takes(q, k) -> bool:
    """Whether K1 takes the shape; a refused one counts in
    ``flash_cuda.routed``."""
    if flash_cuda.flash_supported(q.shape[2], k.shape[2], q.shape[3],
                                  q.dtype):
        return True
    flash_cuda.routed += 1
    return False


def _flash_plain(q, k, v, key_mask, scale):
    out, _ = flash_cuda.flash_attention_plain(q, k, v, key_mask, scale)
    return out.transpose(1, 2).contiguous()


@flash_fwd.register_kernel("cpu")
def _(q, k, v, key_mask, scale):
    _flash_takes(q, k)
    return _flash_plain(q, k, v, key_mask, scale)


@flash_fwd.register_fake
def _(q, k, v, key_mask, scale):
    b, h, tq, d = q.shape
    return q.new_empty((b, tq, h, d))


# -- K2: fused Block1D forward ----------------------------------------------


@torch.library.custom_op("serenade::block1d_fwd", mutates_args=(),
                         device_types="cuda")
def block1d_fwd(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                groups: int, eps: float) -> torch.Tensor:
    """``mish(masked_group_norm(conv_k3(x * mask))) * mask`` ``(B, T,
    Cout)`` in x's dtype.  bf16 reads the weight's taps made once per
    version of ``weight`` (``block1d_cuda.k2_taps``): once per call where
    the program computes the weight (an int8 artifact's dequantization),
    once per load where it is a constant."""
    if not _block1d_takes(x, weight, groups):
        return block1d_cuda.block1d_plain(x, mask, weight, bias, gamma, beta,
                                          groups=groups, eps=eps)
    x, lengths, w, bias, gamma, beta = block1d_cuda.prepare_forward(
        x, mask, weight, bias, gamma, beta)
    taps = (block1d_cuda.k2_taps(weight) if x.dtype == torch.bfloat16
            else None)
    out, _, _ = block1d_cuda._block1d_cuda(x, lengths, w, bias, gamma, beta,
                                           groups, eps, taps=taps)
    return out


def _block1d_takes(x, weight, groups) -> bool:
    """Whether K2 takes the shape; a refused one counts in
    ``block1d_cuda.routed``."""
    if block1d_cuda.block1d_cuda_supported(*x.shape, weight.shape[0], groups,
                                           x.dtype):
        return True
    block1d_cuda.routed += 1
    return False


@block1d_fwd.register_kernel("cpu")
def _(x, mask, weight, bias, gamma, beta, groups, eps):
    _block1d_takes(x, weight, groups)
    return block1d_cuda.block1d_plain(x, mask, weight, bias, gamma, beta,
                                      groups=groups, eps=eps)


@block1d_fwd.register_fake
def _(x, mask, weight, bias, gamma, beta, groups, eps):
    return x.new_empty((*x.shape[:2], weight.shape[0]))


# -- K3: HiFiGAN residual branch --------------------------------------------


@torch.library.custom_op("serenade::resblock_branch", mutates_args=(),
                         device_types="cuda")
def resblock_branch(x: torch.Tensor, w1: List[torch.Tensor],
                    b1: List[torch.Tensor], w2: List[torch.Tensor],
                    b2: List[torch.Tensor], kernel_size: int,
                    dilations: List[int],
                    use_additional_convs: bool) -> torch.Tensor:
    """One residual branch ``(B, T, C)``, its parameters per dilation.
    The f32 kernel splits the weights into TF32 parts once per version of
    the given tensors (``resblock_cuda.tf32_operands``): once per load of
    an artifact, whose vocoder weights are constants."""
    return resblock_cuda._branch_cuda(x.contiguous(), w1, b1, w2, b2,
                                      kernel_size, tuple(dilations),
                                      use_additional_convs)


@resblock_branch.register_kernel("cpu")
def _(x, w1, b1, w2, b2, kernel_size, dilations, use_additional_convs):
    return resblock_cuda.resblock_branch(
        x, w1, b1, w2, b2, kernel_size=kernel_size,
        dilations=tuple(dilations),
        use_additional_convs=use_additional_convs)


@resblock_branch.register_fake
def _(x, w1, b1, w2, b2, kernel_size, dilations, use_additional_convs):
    return torch.empty_like(x, memory_format=torch.contiguous_format)
