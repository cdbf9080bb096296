"""Flash attention with its backward: CUDA kernels ``csrc/flash_fwd.cu``
(K1) and ``csrc/flash_bwd.cu`` (K4, K5).

- K1 replaces ``serenade_tpu/ops/flash_pallas.py:106`` (``_flash_forward``
  → ``_fwd_kernel``): online-softmax attention with a ``(B, Tk)`` key mask
  (padded keys get a -1e30 bias), f32 accumulation, emitting O and the f32
  row logsumexp L.
- K4 replaces ``flash_pallas.py:267`` (``_bwd_dq_kernel``) and K5
  ``flash_pallas.py:291`` (``_bwd_dkv_kernel``): the FlashAttention-2
  backward, recomputing ``P = exp(S - L)`` blockwise; ``D = rowsum(dO∘O)``
  is one PyTorch op outside the kernels, as in JAX.

``flash_attention`` goes through ``FlashAttention`` (a
``torch.autograd.Function``): CUDA tensors launch K1 forward and K4, K5
backward; CPU tensors run ``flash_attention_plain`` and
``flash_attention_backward_plain`` (the JAX formulas step by step, with
JAX's roundings).  bf16 runs on tensor cores, f32 on FMA units.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from serenade_tpu_torch.models.layers import accum_dtype
from serenade_tpu_torch.ops import _cuda

NEG_INF = -1e30
MAX_HEAD_DIM = 512

# kernel launches since the last reset: K1, K4, K5
launches = 0
dq_launches = 0
dkv_launches = 0


def _logits(q, k, key_mask, scale):
    acc = accum_dtype(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale
    if key_mask is not None:
        s = s + (1.0 - key_mask.to(acc))[:, None, None, :] * NEG_INF
    return s


def flash_attention_plain(q, k, v, key_mask: Optional[torch.Tensor],
                          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q ``(B,H,Tq,D)``, k/v ``(B,H,Tk,D)``, key_mask ``(B,Tk)`` 1=valid.
    Returns (O in q's dtype, row logsumexp ``(B,H,Tq)`` in f32)."""
    logits = _logits(q, k, key_mask, scale)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).to(lse.dtype),
                       v.to(lse.dtype))
    return out.to(v.dtype), lse


def flash_attention_backward_plain(q, k, v, key_mask, out, lse, g,
                                   scale: float):
    """(dq, dk, dv) of ``flash_attention_plain`` for the output cotangent
    ``g``, as ``_flash_backward`` computes them: P recomputed from L,
    ``dP = dO·Vᵀ`` and ``dS = P∘(dP - D)·scale`` in f32, dS cast to the
    input type for dQ and dK, P kept f32 for dV.  No query mask: padded
    query rows get dQ from their dO."""
    acc = accum_dtype(q.dtype)
    p = torch.exp(_logits(q, k, key_mask, scale) - lse.to(acc)[..., None])
    gf = g.to(acc)
    dsum = (gf * out.to(acc)).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, v.to(acc))
    ds = p * (dp - dsum) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).to(acc), k.to(acc))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).to(acc), q.to(acc))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _strides(t: torch.Tensor):
    return [ctypes.c_longlong(s) for s in t.stride()[:3]]


def _rows_ok(t: torch.Tensor) -> bool:
    """A contiguous head dim, and 16-byte aligned rows for bf16 loads."""
    if t.stride(3) != 1:
        return False
    return t.dtype != torch.bfloat16 or (
        all(s % 8 == 0 for s in t.stride()[:3]) and t.data_ptr() % 16 == 0)


def _check_inputs(q, k, v, key_mask):
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
        _cuda.require(_rows_ok(t), f"{name}: head_dim must be contiguous "
                      "and bf16 rows 16-byte aligned")
    if key_mask is not None:
        _cuda.require(key_mask.shape == (b, tk) and key_mask.is_cuda,
                      f"key_mask {tuple(key_mask.shape)}")
        key_mask = key_mask.float().contiguous()
    return key_mask


def _mask_ptr(key_mask):
    return ctypes.c_void_p(0 if key_mask is None else key_mask.data_ptr())


def _flash_cuda(q, k, v, key_mask, scale):
    global launches
    b, h, tq, d = q.shape
    tk = k.shape[2]
    key_mask = _check_inputs(q, k, v, key_mask)
    # O is written (B, Tq, H, D): the caller's head merge is then free
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    out_bhtd = out.transpose(1, 2)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    fn = _cuda.library("flash_fwd").serenade_flash_fwd
    fn.restype = ctypes.c_int
    err = fn(_cuda.ptr(q), *_strides(q), _cuda.ptr(k), *_strides(k),
             _cuda.ptr(v), *_strides(v), _mask_ptr(key_mask),
             _cuda.ptr(out), *_strides(out_bhtd), _cuda.ptr(lse),
             ctypes.c_int(b), ctypes.c_int(h), ctypes.c_int(tq),
             ctypes.c_int(tk), ctypes.c_int(d), ctypes.c_float(scale),
             ctypes.c_int(_cuda.DTYPE_CODE[q.dtype]), _cuda.stream())
    _cuda.check(err, "flash_fwd")
    launches += 1
    return out_bhtd, lse


def flash_bwd_prepare(out, g, dtype):
    """dO in the input type with kernel-ready rows, and the f32 row term
    ``D = rowsum(dO∘O)`` ``(B, H, Tq)`` (one PyTorch op, as in JAX)."""
    g = g.to(dtype)
    if not _rows_ok(g):
        g = g.contiguous()
    return g, (g.float() * out.float()).sum(dim=-1).contiguous()


def _bwd_args(q, k, v, key_mask, g, lse, dsum):
    """The kernels' leading arguments, and the f32 key mask they point to
    (the caller keeps it alive until the launch)."""
    b, h, tq, d = q.shape
    key_mask = _check_inputs(q, k, v, key_mask)
    _cuda.require(q.dtype != torch.bfloat16 or d % 128 == 0,
                  f"bf16 backward: head_dim {d} must be a multiple of 128")
    _cuda.require(g.shape == q.shape and g.dtype == q.dtype and g.is_cuda
                  and _rows_ok(g), f"grad {tuple(g.shape)} {g.dtype}")
    for name, t in (("lse", lse), ("dsum", dsum)):
        _cuda.require(t.shape == (b, h, tq) and t.dtype == torch.float32
                      and t.is_contiguous() and t.is_cuda,
                      f"{name} must be f32 (B, H, Tq)")
    return (_cuda.ptr(q), *_strides(q), _cuda.ptr(k), *_strides(k),
            _cuda.ptr(v), *_strides(v), _mask_ptr(key_mask),
            _cuda.ptr(g), *_strides(g), _cuda.ptr(lse),
            _cuda.ptr(dsum)), key_mask


def _dims(q, k, scale):
    b, h, tq, d = q.shape
    return (ctypes.c_int(b), ctypes.c_int(h), ctypes.c_int(tq),
            ctypes.c_int(k.shape[2]), ctypes.c_int(d), ctypes.c_float(scale),
            ctypes.c_int(_cuda.DTYPE_CODE[q.dtype]), _cuda.stream())


def flash_bwd_dq(q, k, v, key_mask, g, lse, dsum, scale):
    """K4: dQ, written (B, Tq, H, D) and returned as a (B, H, Tq, D) view.
    ``g``/``dsum`` as ``flash_bwd_prepare`` gives them."""
    global dq_launches
    b, h, tq, d = q.shape
    args, key_mask = _bwd_args(q, k, v, key_mask, g, lse, dsum)
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    dq_v = dq.transpose(1, 2)
    fn = _cuda.library("flash_bwd").serenade_flash_bwd_dq
    fn.restype = ctypes.c_int
    _cuda.check(fn(*args, _cuda.ptr(dq), *_strides(dq_v),
                   *_dims(q, k, scale)), "flash_bwd_dq")
    dq_launches += 1
    return dq_v


def flash_bwd_dkv(q, k, v, key_mask, g, lse, dsum, scale):
    """K5: (dK, dV), written (B, Tk, H, D) and returned as views."""
    global dkv_launches
    b, h, _, d = q.shape
    tk = k.shape[2]
    args, key_mask = _bwd_args(q, k, v, key_mask, g, lse, dsum)
    dk = torch.empty((b, tk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    dk_v, dv_v = dk.transpose(1, 2), dv.transpose(1, 2)
    fn = _cuda.library("flash_bwd").serenade_flash_bwd_dkv
    fn.restype = ctypes.c_int
    _cuda.check(fn(*args, _cuda.ptr(dk), *_strides(dk_v), _cuda.ptr(dv),
                   *_strides(dv_v), *_dims(q, k, scale)), "flash_bwd_dkv")
    dkv_launches += 1
    return dk_v, dv_v


def _flash_bwd_cuda(q, k, v, key_mask, out, lse, g, scale):
    g, dsum = flash_bwd_prepare(out, g, q.dtype)
    dq = flash_bwd_dq(q, k, v, key_mask, g, lse, dsum, scale)
    return (dq, *flash_bwd_dkv(q, k, v, key_mask, g, lse, dsum, scale))


class FlashAttention(torch.autograd.Function):
    """K1 forward, K4 + K5 backward on CUDA; the plain versions on the CPU.
    Saves q, k, v, the key mask, O and L, as ``flash_pallas._fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale):
        if q.is_cuda:
            out, lse = _flash_cuda(q, k, v, key_mask, scale)
        else:
            out, lse = flash_attention_plain(q, k, v, key_mask, scale)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        bwd = _flash_bwd_cuda if q.is_cuda else flash_attention_backward_plain
        dq, dk, dv = bwd(q, k, v, key_mask, out, lse, g, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, key_mask: Optional[torch.Tensor], scale: float,
                    return_lse: bool = False):
    """Flash attention over ``(B, H, T, D)`` heads (any strides with a
    contiguous head_dim), differentiable in q, k and v.  CUDA tensors run
    the kernels; CPU tensors run the plain versions.  The CUDA result is a
    ``(B, H, T, D)`` view of a ``(B, T, H, D)`` buffer."""
    out, lse = FlashAttention.apply(q, k, v, key_mask, scale)
    return (out, lse) if return_lse else out
