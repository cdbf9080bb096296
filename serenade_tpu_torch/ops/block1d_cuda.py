"""K2: fused Block1D forward, CUDA kernels ``csrc/block1d_fwd.cu``.

Replaces ``serenade_tpu/ops/block1d_pallas.py:255`` (``_fused_block1d_fwd``
→ ``_fwd_kernel``): ``mish(masked_group_norm(conv_k3(x·mask)))·mask`` with
prefix masks.  One wrapper call launches two kernels (conv + bias +
per-group statistics, then normalize + affine + Mish + mask) and counts
as one launch.  CPU tensors run ``block1d_plain`` (conv1d + two-pass
``masked_group_norm`` + mish, the unfused JAX ``Block1D``).
"""

from __future__ import annotations

import ctypes

import torch

from serenade_tpu_torch.models.layers import conv1d, masked_group_norm, mish
from serenade_tpu_torch.ops import _cuda

launches = 0   # wrapper calls that launched the kernels since the last reset


def block1d_plain(x, mask, weight, bias, gamma, beta, *, groups: int = 8,
                  eps: float = 1e-5):
    """x ``(B,T,Cin)``, mask ``(B,T,1)``, weight ``(Cout,Cin,3)``."""
    h = (x * mask).to(x.dtype)
    h = conv1d(h, weight.to(x.dtype), bias.to(x.dtype), padding=(1, 1))
    h = masked_group_norm(h, mask, gamma, beta, num_groups=groups,
                          epsilon=eps, out_dtype=x.dtype)
    return (mish(h) * mask).to(x.dtype)


def _block1d_cuda(x, lengths, weight, bias, gamma, beta, groups, eps):
    global launches
    b, t, cin = x.shape
    cout = weight.shape[0]
    dev = x.device
    _cuda.require(x.dtype in _cuda.DTYPE_CODE, f"dtype {x.dtype}")
    _cuda.require(x.is_contiguous(), "x must be contiguous (B, T, Cin)")
    _cuda.require(weight.shape == (cout, cin, 3) and weight.dtype == x.dtype
                  and weight.is_contiguous() and weight.device == dev,
                  f"weight {tuple(weight.shape)} {weight.dtype}")
    _cuda.require(cout % groups == 0 and cout % 4 == 0,
                  f"Cout {cout} must divide into {groups} groups and by 4")
    for name, p in (("bias", bias), ("gamma", gamma), ("beta", beta)):
        _cuda.require(p.shape == (cout,) and p.dtype == torch.float32
                      and p.is_contiguous() and p.device == dev,
                      f"{name} must be f32 ({cout},) on {dev}")
    _cuda.require(lengths.shape == (b,) and lengths.dtype == torch.int32
                  and lengths.device == dev, "lengths must be int32 (B,)")
    y = torch.empty((b, t, cout), dtype=torch.float32, device=dev)
    stats = torch.zeros((b, groups, 2), dtype=torch.float64, device=dev)
    out = torch.empty((b, t, cout), dtype=x.dtype, device=dev)
    fn = _cuda.library("block1d_fwd").serenade_block1d_fwd
    fn.restype = ctypes.c_int
    err = fn(_cuda.ptr(x), _cuda.ptr(lengths), _cuda.ptr(weight),
             _cuda.ptr(bias), _cuda.ptr(gamma), _cuda.ptr(beta),
             _cuda.ptr(y), _cuda.ptr(stats), _cuda.ptr(out),
             ctypes.c_int(b), ctypes.c_int(t), ctypes.c_int(cin),
             ctypes.c_int(cout), ctypes.c_int(groups), ctypes.c_float(eps),
             ctypes.c_int(_cuda.DTYPE_CODE[x.dtype]), _cuda.stream())
    _cuda.check(err, "block1d_fwd")
    launches += 1
    return out


def block1d(x, mask, weight, bias, gamma, beta, *, groups: int = 8,
            eps: float = 1e-5):
    """Fused ``mish(masked_group_norm(conv_k3(x * mask))) * mask``.

    Args:
        x: ``(B, T, Cin)`` activations in the compute dtype.
        mask: ``(B, T, 1)`` contiguous-prefix validity mask (every mask the
            UNet builds is one: length masks halved per level).
        weight: ``(Cout, Cin, 3)``; bias ``(Cout,)`` conv parameters.
        gamma, beta: ``(Cout,)`` GroupNorm affine, applied in f32.
    """
    if not x.is_cuda:
        return block1d_plain(x, mask, weight, bias, gamma, beta,
                             groups=groups, eps=eps)
    lengths = mask[:, :, 0].sum(dim=1).to(torch.int32)
    return _block1d_cuda(x.contiguous(), lengths, weight.contiguous(),
                         bias.float().contiguous(), gamma.float().contiguous(),
                         beta.float().contiguous(), groups, eps)
