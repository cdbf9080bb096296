"""K1: flash-attention forward, CUDA kernel ``csrc/flash_fwd.cu``.

Replaces ``serenade_tpu/ops/flash_pallas.py:106`` (``_flash_forward`` →
``_fwd_kernel``): online-softmax attention with a ``(B, Tk)`` key mask
(padded keys get a -1e30 bias), f32 accumulation, emitting O and the f32
row logsumexp.  bf16 runs on tensor cores, f32 on FMA units.
``flash_attention`` launches the kernel for CUDA tensors and runs
``flash_attention_plain`` (the einsum + f32 softmax of ``_xla_attention``)
for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from serenade_tpu_torch.ops import _cuda

NEG_INF = -1e30
MAX_HEAD_DIM = 512

launches = 0   # kernel launches since the last reset


def flash_attention_plain(q, k, v, key_mask: Optional[torch.Tensor],
                          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q ``(B,H,Tq,D)``, k/v ``(B,H,Tk,D)``, key_mask ``(B,Tk)`` 1=valid.
    Returns (O in q's dtype, f32 row logsumexp ``(B,H,Tq)``)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        logits = logits + (1.0 - key_mask.float())[:, None, None, :] * NEG_INF
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype), lse


def _strides(t: torch.Tensor):
    return [ctypes.c_longlong(s) for s in t.stride()[:3]]


def _flash_cuda(q, k, v, key_mask, scale):
    global launches
    b, h, tq, d = q.shape
    tk = k.shape[2]
    _cuda.require(q.dtype in _cuda.DTYPE_CODE, f"dtype {q.dtype}")
    _cuda.require(k.dtype == q.dtype and v.dtype == q.dtype,
                  "q, k, v must share one dtype")
    _cuda.require(k.is_cuda and v.is_cuda, "q, k, v must all be on CUDA")
    _cuda.require(k.shape == (b, h, tk, d) and v.shape == k.shape,
                  f"shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    _cuda.require(d % 32 == 0 and d <= MAX_HEAD_DIM,
                  f"head_dim {d}: a multiple of 32 up to {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _cuda.require(t.stride(3) == 1, f"{name}: head_dim must be contiguous")
        if q.dtype == torch.bfloat16:   # the tensor-core path loads 16 bytes
            _cuda.require(all(s % 8 == 0 for s in t.stride()[:3])
                          and t.data_ptr() % 16 == 0,
                          f"{name}: rows must be 16-byte aligned")
    if key_mask is not None:
        _cuda.require(key_mask.shape == (b, tk) and key_mask.is_cuda,
                      f"key_mask {tuple(key_mask.shape)}")
        key_mask = key_mask.float().contiguous()
    # O is written (B, Tq, H, D): the caller's head merge is then free
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    out_bhtd = out.transpose(1, 2)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _cuda.library("flash_fwd")
    fn = lib.serenade_flash_fwd
    fn.restype = ctypes.c_int
    err = fn(_cuda.ptr(q), *_strides(q), _cuda.ptr(k), *_strides(k),
             _cuda.ptr(v), *_strides(v),
             ctypes.c_void_p(0 if key_mask is None else key_mask.data_ptr()),
             _cuda.ptr(out), *_strides(out_bhtd), _cuda.ptr(lse),
             ctypes.c_int(b), ctypes.c_int(h), ctypes.c_int(tq),
             ctypes.c_int(tk), ctypes.c_int(d), ctypes.c_float(scale),
             ctypes.c_int(_cuda.DTYPE_CODE[q.dtype]), _cuda.stream())
    _cuda.check(err, "flash_fwd")
    launches += 1
    return out_bhtd, lse


def flash_attention(q, k, v, key_mask: Optional[torch.Tensor], scale: float,
                    return_lse: bool = False):
    """Flash attention over ``(B, H, T, D)`` heads (any strides with a
    contiguous head_dim).  CUDA tensors run the kernel; CPU tensors run
    the plain version.  The CUDA result is a ``(B, H, T, D)`` view of a
    ``(B, T, H, D)`` buffer."""
    if q.is_cuda:
        out, lse = _flash_cuda(q, k, v, key_mask, scale)
    else:
        out, lse = flash_attention_plain(q, k, v, key_mask, scale)
    return (out, lse) if return_lse else out
