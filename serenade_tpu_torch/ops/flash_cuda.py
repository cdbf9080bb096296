"""Flash attention with its backward: CUDA kernels ``csrc/flash_fwd.cu``
(K1) and ``csrc/flash_bwd.cu`` (K4, K5).

- K1 replaces ``serenade_tpu/ops/flash_pallas.py:106`` (``_flash_forward``
  → ``_fwd_kernel``): online-softmax attention with a ``(B, Tk)`` key mask
  (padded keys get a -1e30 bias), f32 accumulation, emitting O and the f32
  row logsumexp L.
- K4 replaces ``flash_pallas.py:267`` (``_bwd_dq_kernel``) and K5
  ``flash_pallas.py:291`` (``_bwd_dkv_kernel``): the FlashAttention-2
  backward, recomputing ``P = exp(S - L)`` blockwise; ``D = rowsum(dO∘O)``
  is one PyTorch op outside the kernels, as in JAX.  K4's and K5's bf16
  kernels run on Hopper's wgmma as ``k4_plan`` and ``k5_plan`` lay them
  out (head_dim 512 only).

``flash_attention`` goes through ``FlashAttention`` (a
``torch.autograd.Function``): CUDA tensors launch K1 forward and K4, K5
backward; CPU tensors run ``flash_attention_plain`` and
``flash_attention_backward_plain`` (the JAX formulas step by step, with
JAX's roundings).  bf16 runs on tensor cores, f32 on FMA units.  The
planners refuse the shapes their kernels do not take; ``flash_supported``
says which shapes all three take, and ``attention.multi_head_attention``
routes the others to the plain version before anything is launched.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from serenade_tpu_torch.ops.primitives import accum_dtype
from serenade_tpu_torch.ops import _cuda

NEG_INF = -1e30
MAX_HEAD_DIM = 512

# kernel launches since the last reset: K1, K4, K5; and the square
# attentions ``attention.multi_head_attention`` routed to the plain version
# because a kernel of the pair does not take their shape
launches = 0
dq_launches = 0
dkv_launches = 0
routed = 0


def flash_supported(tq: int, tk: int, d: int, dtype) -> bool:
    """Whether K1 and its backward K4, K5 all take this shape: in bf16
    square attention at head_dim 512 (the Hopper kernels' one head dim), in
    f32 a head_dim that is a multiple of 32 up to 512.  The planners
    refuse what this rejects, and JAX likewise sends any other shape to
    its XLA attention (``serenade_tpu/ops/attention.py``)."""
    if dtype == torch.bfloat16:
        return tq == tk and d == K1_BF16_HEAD_DIM
    return dtype == torch.float32 and d % 32 == 0 and d <= MAX_HEAD_DIM


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
    for name, t in (("q", q), ("k", k), ("v", v)):
        _cuda.require(_rows_ok(t), f"{name}: head_dim must be contiguous "
                      "and bf16 rows 16-byte aligned")
    if key_mask is not None:
        _cuda.require(key_mask.shape == (b, tk) and key_mask.is_cuda,
                      f"key_mask {tuple(key_mask.shape)}")
        key_mask = key_mask.float().contiguous()
    return key_mask


def _f32_head_dim(d: int) -> None:
    _cuda.require(d % 32 == 0 and d <= MAX_HEAD_DIM, f"f32 flash: head_dim "
                  f"{d}; the kernels take a multiple of 32 up to "
                  f"{MAX_HEAD_DIM}")


def _mask_ptr(key_mask):
    return ctypes.c_void_p(0 if key_mask is None else key_mask.data_ptr())


# K1's bf16 kernel: head_dim 512, a CTA of 384 threads per 64 query rows,
# Q (64 KB), two stages of K and V (64 KB each) and the S exchange (32 KB)
# in shared memory, plus 1 KB for alignment.  The C entry checks a plan
# against the kernels' own constants and refuses one that does not match.
K1_BF16_HEAD_DIM = 512
K1_BF16_ROWS = 64
K1_BF16_SMEM = 64 * 1024 + 2 * 64 * 1024 + 32 * 1024 + 1024
K1_F32_ROWS, K1_F32_KEYS = 32, 32


def k1_plan(b: int, h: int, tq: int, d: int, dtype, sm_count: int) -> dict:
    """K1's launch for a shape and a card of ``sm_count`` multiprocessors,
    as ``_flash_cuda`` passes it to the kernel: the grid, threads and
    dynamic shared memory; with the CTAs and the SMs they occupy (one CTA
    per SM: either kernel's shared memory holds one).  Raises
    ``ValueError`` on a head dim the kernel of that dtype does not take."""
    if dtype == torch.bfloat16:
        _cuda.require(d == K1_BF16_HEAD_DIM, f"bf16 flash forward: head_dim "
                      f"{d}; the Hopper kernel takes {K1_BF16_HEAD_DIM} only")
        rows, threads, smem = K1_BF16_ROWS, 384, K1_BF16_SMEM
    else:
        _f32_head_dim(d)
        rows, threads = K1_F32_ROWS, 256
        smem = 4 * ((K1_F32_ROWS + K1_F32_KEYS) * (d + 4) + K1_F32_KEYS * d
                    + K1_F32_ROWS * (K1_F32_KEYS + 1))
    grid = (-(-tq // rows), h, b)
    ctas = grid[0] * h * b
    return {"grid": grid, "threads": threads, "smem_bytes": smem,
            "ctas": ctas, "sms_used": min(ctas, sm_count)}


def _flash_cuda(q, k, v, key_mask, scale):
    global launches
    b, h, tq, d = q.shape
    tk = k.shape[2]
    key_mask = _check_inputs(q, k, v, key_mask)
    plan = k1_plan(b, h, tq, d, q.dtype, _cuda.sm_count(q.device))
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
             ctypes.c_int(_cuda.DTYPE_CODE[q.dtype]),
             ctypes.c_int(plan["grid"][0]), ctypes.c_int(plan["threads"]),
             ctypes.c_int(plan["smem_bytes"]), _cuda.stream())
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
    b, h, tq, _ = q.shape
    key_mask = _check_inputs(q, k, v, key_mask)
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


# K4's bf16 kernel: head_dim 512, a CTA of 384 threads per 64 query rows
# of one (b, h), Q and dO resident (64 KB each), a ring of five 16 KB
# slots of half K or V tiles (32 keys x 256 columns), the dS tile (8 KB)
# and 1 KB for alignment.  The C entry checks a plan against the kernels'
# own constants and refuses one that does not match.
K4_BF16_HEAD_DIM = 512
K4_BF16_QUERIES, K4_BF16_KEYS, K4_BF16_SLOTS = 64, 32, 5
K4_BF16_SMEM = (2 * 64 * 1024 + K4_BF16_SLOTS * 16 * 1024 + 64 * 128
                + 1024)
K4_F32_ROWS = 16


def k4_plan(b: int, h: int, tq: int, tk: int, d: int, dtype,
            sm_count: int) -> dict:
    """K4's launch for a shape and a card of ``sm_count`` multiprocessors,
    as ``flash_bwd_dq`` passes it to the kernel: the grid (query blocks,
    H, B), threads and dynamic shared memory; with the query rows a CTA
    owns, the key tile it walks and how many, the ring's slots, the CTAs
    and the SMs they occupy (one CTA per SM).  Raises ``ValueError`` on a
    head dim the kernel of that dtype does not take; never falls back."""
    if dtype == torch.bfloat16:
        _cuda.require(d == K4_BF16_HEAD_DIM, f"bf16 flash dQ: head_dim "
                      f"{d}; the Hopper kernel takes {K4_BF16_HEAD_DIM} only")
        rows, keys, slots = K4_BF16_QUERIES, K4_BF16_KEYS, K4_BF16_SLOTS
        threads, smem = 384, K4_BF16_SMEM
    else:
        _f32_head_dim(d)
        rows = keys = K4_F32_ROWS
        slots, threads = 0, 256
        smem = 4 * (4 * K4_F32_ROWS * (d + 1) + K4_F32_ROWS
                    * (K4_F32_ROWS + 1))
    grid = (-(-tq // rows), h, b)
    ctas = grid[0] * h * b
    return {"grid": grid, "threads": threads, "smem_bytes": smem,
            "query_rows": rows, "key_tile": keys, "key_tiles": -(-tk // keys),
            "slots": slots, "ctas": ctas, "sms_used": min(ctas, sm_count)}


def flash_bwd_dq(q, k, v, key_mask, g, lse, dsum, scale):
    """K4: dQ, written (B, Tq, H, D) and returned as a (B, H, Tq, D) view.
    ``g``/``dsum`` as ``flash_bwd_prepare`` gives them."""
    global dq_launches
    b, h, tq, d = q.shape
    args, key_mask = _bwd_args(q, k, v, key_mask, g, lse, dsum)
    plan = k4_plan(b, h, tq, k.shape[2], d, q.dtype, _cuda.sm_count(q.device))
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    dq_v = dq.transpose(1, 2)
    fn = _cuda.library("flash_bwd").serenade_flash_bwd_dq
    fn.restype = ctypes.c_int
    *dims, stream = _dims(q, k, scale)
    _cuda.check(fn(*args, _cuda.ptr(dq), *_strides(dq_v), *dims,
                   ctypes.c_int(plan["grid"][0]),
                   ctypes.c_int(plan["threads"]),
                   ctypes.c_int(plan["smem_bytes"]), stream),
                "flash_bwd_dq")
    dq_launches += 1
    return dq_v


# K5's bf16 kernel: head_dim 512, a CTA of 384 threads per 32 keys of one
# (b, h), looping over 64-query tiles with one stage each of Q and dO (64
# KB each), K and V (32 KB each), the P and dS tiles (3 x 4 KB) and 1 KB
# for alignment.  The C entry checks a plan
# against the kernels' own constants and refuses one that does not match.
K5_BF16_HEAD_DIM = 512
K5_BF16_KEYS, K5_BF16_QUERIES = 32, 64
K5_BF16_SMEM = 2 * 64 * 1024 + 2 * 32 * 1024 + 3 * 4096 + 1024
K5_F32_KEYS = 16


def k5_plan(b: int, h: int, tq: int, tk: int, d: int, dtype,
            sm_count: int) -> dict:
    """K5's launch for a shape and a card of ``sm_count`` multiprocessors,
    as ``flash_bwd_dkv`` passes it to the kernel: the grid (key blocks, H,
    B), threads and dynamic shared memory; with the keys a CTA owns, the
    query tile it loops over, its Q / dO stages, the CTAs and the SMs
    they occupy (one CTA per SM).  Raises ``ValueError`` on a head dim
    the kernel of that dtype does not take; never falls back."""
    if dtype == torch.bfloat16:
        _cuda.require(d == K5_BF16_HEAD_DIM, f"bf16 flash dK/dV: head_dim "
                      f"{d}; the Hopper kernel takes {K5_BF16_HEAD_DIM} only")
        keys, queries, stages = K5_BF16_KEYS, K5_BF16_QUERIES, 1
        threads, smem = 384, K5_BF16_SMEM
    else:
        _f32_head_dim(d)
        keys, queries, stages, threads = K5_F32_KEYS, K5_F32_KEYS, 0, 256
        smem = 4 * (4 * K5_F32_KEYS * (d + 1) + 2 * K5_F32_KEYS
                    * (K5_F32_KEYS + 1) + 2 * K5_F32_KEYS)
    grid = (-(-tk // keys), h, b)
    ctas = grid[0] * h * b
    return {"grid": grid, "threads": threads, "smem_bytes": smem,
            "keys": keys, "query_tile": queries, "stages": stages,
            "query_tiles": -(-tq // queries), "ctas": ctas,
            "sms_used": min(ctas, sm_count)}


def flash_bwd_dkv(q, k, v, key_mask, g, lse, dsum, scale):
    """K5: (dK, dV), written (B, Tk, H, D) and returned as views."""
    global dkv_launches
    b, h, tq, d = q.shape
    tk = k.shape[2]
    args, key_mask = _bwd_args(q, k, v, key_mask, g, lse, dsum)
    plan = k5_plan(b, h, tq, tk, d, q.dtype, _cuda.sm_count(q.device))
    dk = torch.empty((b, tk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    dk_v, dv_v = dk.transpose(1, 2), dv.transpose(1, 2)
    fn = _cuda.library("flash_bwd").serenade_flash_bwd_dkv
    fn.restype = ctypes.c_int
    *dims, stream = _dims(q, k, scale)
    _cuda.check(fn(*args, _cuda.ptr(dk), *_strides(dk_v), _cuda.ptr(dv),
                   *_strides(dv_v), *dims, ctypes.c_int(plan["grid"][0]),
                   ctypes.c_int(plan["threads"]),
                   ctypes.c_int(plan["smem_bytes"]), stream),
                "flash_bwd_dkv")
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
    ``(B, H, T, D)`` view of a ``(B, T, H, D)`` buffer.  While a program is
    exported, the output goes through the custom op
    ``serenade::flash_fwd`` (``ops/custom_ops.py``), which it can hold."""
    if torch.compiler.is_exporting() and not return_lse:
        from serenade_tpu_torch.ops import custom_ops

        return custom_ops.flash_fwd(q, k, v, key_mask, scale).transpose(1, 2)
    out, lse = FlashAttention.apply(q, k, v, key_mask, scale)
    return (out, lse) if return_lse else out
