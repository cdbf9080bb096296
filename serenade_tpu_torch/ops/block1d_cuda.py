"""Fused Block1D with its backward: CUDA kernels ``csrc/block1d_fwd.cu``
(K2) and ``csrc/block1d_bwd.cu`` (K6, K7).

- K2 replaces ``serenade_tpu/ops/block1d_pallas.py:255``
  (``_fused_block1d_fwd`` → ``_fwd_kernel``):
  ``mish(masked_group_norm(conv_k3(x·mask)))·mask`` with prefix masks.
  One wrapper call launches two kernels (conv + bias + per-group
  statistics, then normalize + affine + Mish + mask) and counts as one
  launch.
- K6 replaces ``block1d_pallas.py:296`` (``_bwd_data_kernel``): Mish′,
  the GroupNorm backward, dγ, dβ, dbias and dx by the transposed taps.
- K7 replaces ``block1d_pallas.py:343`` (``_bwd_w_kernel``): dW, reduced
  over batch and time.

``block1d`` goes through ``Block1DFunction``.  On CUDA the forward keeps
K2's f32 conv output y and f64 group sums for K6, where the Pallas
backward recomputes them.  CPU tensors run ``block1d_plain`` (conv1d +
two-pass ``masked_group_norm`` + mish, the unfused JAX ``Block1D``) and
``block1d_backward_plain`` (the Pallas backward's formulas step by step;
K7's part alone is ``block1d_weight_grad_plain``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from serenade_tpu_torch.models.layers import (
    accum_dtype,
    conv1d,
    masked_group_norm,
    mish,
)
from serenade_tpu_torch.ops import _cuda

# wrapper calls that launched each kernel since the last reset: K2, K6, K7
launches = 0
data_launches = 0
weight_launches = 0


def block1d_plain(x, mask, weight, bias, gamma, beta, *, groups: int = 8,
                  eps: float = 1e-5):
    """x ``(B,T,Cin)``, mask ``(B,T,1)``, weight ``(Cout,Cin,3)``."""
    h = (x * mask).to(x.dtype)
    h = conv1d(h, weight.to(x.dtype), bias.to(x.dtype), padding=(1, 1))
    h = masked_group_norm(h, mask, gamma, beta, num_groups=groups,
                          epsilon=eps, out_dtype=x.dtype)
    return (mish(h) * mask).to(x.dtype)


def block1d_backward_plain(x, mask, weight, bias, gamma, beta, g, *,
                           groups: int = 8, eps: float = 1e-5):
    """(dx, dweight, dbias, dgamma, dbeta) of ``block1d_plain`` for the
    output cotangent ``g``, with the roundings of ``_bwd_data_kernel`` and
    ``_bwd_w_kernel``: conv products of compute-type values accumulated in
    f32, dy cast to x's type for dx and dW, dbias from the f32 dy; dx in
    x's type, the parameter gradients in f32."""
    acc = accum_dtype(x.dtype)
    b, t, _ = x.shape
    cout = weight.shape[0]
    cg = cout // groups
    m = mask.to(acc)
    xm = (x * mask).to(x.dtype).to(acc)
    w = weight.to(x.dtype).to(acc)
    y = conv1d(xm, w, bias.to(x.dtype).to(acc), padding=(1, 1))

    def group_sum(a):   # (B,T,C) -> (B,1,G,1) sums over valid frames
        return (a * m).reshape(b, t, groups, cg).sum(dim=(1, 3), keepdim=True)

    def per_channel(a):  # (B,1,G,1) -> (B,1,C)
        return a.expand(b, 1, groups, cg).reshape(b, 1, cout)

    denom = torch.clamp(m.sum(dim=1, keepdim=True) * cg, min=1.0)
    mean = per_channel(group_sum(y)) / denom
    var = per_channel(group_sum(torch.square(y - mean))) / denom
    rstd = torch.rsqrt(var + eps)
    yhat = (y - mean) * rstd
    gam = gamma.to(acc)
    z = yhat * gam + beta.to(acc)
    # Mish'(z) from one exponential (block1d_pallas.py:58-64)
    u = 1.0 + torch.exp(torch.clamp(z, max=20.0))
    t_sp = (u * u - 1.0) / (u * u + 1.0)
    sig = (u - 1.0) / u
    dz = g.to(acc) * m * (t_sp + z * (1.0 - t_sp * t_sp) * sig)
    dgamma = (dz * yhat).sum(dim=(0, 1))
    dbeta = dz.sum(dim=(0, 1))
    dyhat = dz * gam
    a1 = per_channel(group_sum(dyhat)) / denom
    a2 = per_channel(group_sum(dyhat * yhat)) / denom
    dy = m * rstd * (dyhat - a1 - yhat * a2)
    dbias = dy.sum(dim=(0, 1))
    dyc = dy.to(x.dtype).to(acc)
    # dx[s] = sum_j dy[s+1-j] W[j]^T: a conv by the flipped, transposed taps
    dx = conv1d(dyc, w.flip(2).transpose(0, 1), padding=(1, 1)) * m
    dw = block1d_weight_grad_plain(x, mask, dy.to(x.dtype))
    return (dx.to(x.dtype), dw, dbias, dgamma, dbeta)


def block1d_weight_grad_plain(x, mask, dy):
    """dW ``(Cout, Cin, 3)`` of ``_bwd_w_kernel``:
    ``dW[:, :, j] = Σ_{b,t} dy[t]ᵀ·(x·m)[t-1+j]`` from x's-type values,
    accumulated in f32 (the plain version of K7 alone)."""
    acc = accum_dtype(x.dtype)
    t = x.shape[1]
    xp = F.pad((x * mask).to(x.dtype).to(acc).transpose(1, 2), (1, 1))
    dyc = dy.to(x.dtype).to(acc)                         # (B, T, Cout)
    return torch.stack([torch.einsum("bit,bto->oi", xp[:, :, j:j + t], dyc)
                        for j in range(3)], dim=-1)


def _check_params(x, weight, params, groups):
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
    for name, p in params.items():
        _cuda.require(p.shape == (cout,) and p.dtype == torch.float32
                      and p.is_contiguous() and p.device == dev,
                      f"{name} must be f32 ({cout},) on {dev}")


def _lengths(mask, b):
    lengths = mask[:, :, 0].sum(dim=1).to(torch.int32)
    _cuda.require(lengths.shape == (b,) and lengths.device == mask.device,
                  "mask must be (B, T, 1) on the input's device")
    return lengths


def prepare_forward(x, mask, weight, bias, gamma, beta):
    """K2's arguments from ``block1d``'s: x contiguous, lengths from the
    prefix mask, the weight in x's type, the conv bias rounded to the
    compute type (as the Pallas kernel takes it) and held in f32, the
    affine in f32."""
    x = x.contiguous()
    return (x, _lengths(mask, x.shape[0]), weight.to(x.dtype).contiguous(),
            bias.to(x.dtype).float().contiguous(),
            gamma.float().contiguous(), beta.float().contiguous())


def _block1d_cuda(x, lengths, weight, bias, gamma, beta, groups, eps):
    """K2.  Returns (out, y, stats): y the f32 conv output, stats the f64
    per-(sample, group) sum and sum of squares over valid frames."""
    global launches
    b, t, cin = x.shape
    cout = weight.shape[0]
    dev = x.device
    _check_params(x, weight, {"bias": bias, "gamma": gamma, "beta": beta},
                  groups)
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
    return out, y, stats


def k7_chunks(b: int, t: int, cin: int, cout: int, sm_count: int) -> int:
    """Time chunks of K7's split-K grid: enough blocks for ~4 waves of the
    card's ``sm_count`` multiprocessors, never more chunks than 64-row
    tiles."""
    tiles = b * -(-t // 64)
    blocks = -(-cout // 64) * -(-cin // 64)
    return max(1, min(tiles, 4 * sm_count // blocks))


def block1d_bwd_data(x, lengths, weight, gamma, beta, y, stats, g, *,
                     groups: int = 8, eps: float = 1e-5):
    """K6 (three kernels, one launch count).  ``weight`` in x's type, y and
    stats from K2.  Returns (dx, dy in x's type, (3, Cout) f32 rows dgamma,
    dbeta, dbias)."""
    global data_launches
    b, t, _ = x.shape
    cout = weight.shape[0]
    dev = x.device
    _check_params(x, weight, {"gamma": gamma, "beta": beta}, groups)
    _cuda.require(y.shape == (b, t, cout) and y.dtype == torch.float32
                  and y.is_contiguous() and stats.shape == (b, groups, 2)
                  and stats.dtype == torch.float64, "y, stats as K2 gives")
    _cuda.require(g.shape == (b, t, cout) and g.dtype == x.dtype
                  and g.is_contiguous() and g.device == dev,
                  f"grad {tuple(g.shape)} {g.dtype}")
    _cuda.require(lengths.shape == (b,) and lengths.dtype == torch.int32
                  and lengths.device == dev, "lengths must be int32 (B,)")
    gsum = torch.zeros((b, groups, 2), dtype=torch.float64, device=dev)
    dx = torch.empty_like(x)
    dy = torch.empty((b, t, cout), dtype=x.dtype, device=dev)
    dparams = torch.zeros((3, cout), dtype=torch.float32, device=dev)
    fn = _cuda.library("block1d_bwd").serenade_block1d_bwd_data
    fn.restype = ctypes.c_int
    err = fn(_cuda.ptr(lengths), _cuda.ptr(weight), _cuda.ptr(y),
             _cuda.ptr(stats), _cuda.ptr(gamma), _cuda.ptr(beta),
             _cuda.ptr(g), _cuda.ptr(gsum), _cuda.ptr(dx), _cuda.ptr(dy),
             _cuda.ptr(dparams), ctypes.c_int(b), ctypes.c_int(t),
             ctypes.c_int(x.shape[2]), ctypes.c_int(cout),
             ctypes.c_int(groups), ctypes.c_float(eps),
             ctypes.c_int(_cuda.DTYPE_CODE[x.dtype]), _cuda.stream())
    _cuda.check(err, "block1d_bwd_data")
    data_launches += 1
    return dx, dy, dparams


def block1d_bwd_weight(x, lengths, dy):
    """K7: dW ``(Cout, Cin, 3)`` in f32 from x and K6's dy."""
    global weight_launches
    b, t, cin = x.shape
    cout = dy.shape[2]
    dev = x.device
    _cuda.require(x.dtype in _cuda.DTYPE_CODE and x.is_contiguous(),
                  f"x {x.dtype} must be contiguous (B, T, Cin)")
    _cuda.require(dy.shape == (b, t, cout) and dy.dtype == x.dtype
                  and dy.is_contiguous() and dy.device == dev,
                  f"dy {tuple(dy.shape)} {dy.dtype}")
    _cuda.require(lengths.shape == (b,) and lengths.dtype == torch.int32
                  and lengths.device == dev, "lengths must be int32 (B,)")
    dw = torch.zeros((cout, cin, 3), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = _cuda.library("block1d_bwd").serenade_block1d_bwd_weight
    fn.restype = ctypes.c_int
    err = fn(_cuda.ptr(x), _cuda.ptr(lengths), _cuda.ptr(dy), _cuda.ptr(dw),
             ctypes.c_int(b), ctypes.c_int(t), ctypes.c_int(cin),
             ctypes.c_int(cout), ctypes.c_int(k7_chunks(b, t, cin, cout, sms)),
             ctypes.c_int(_cuda.DTYPE_CODE[x.dtype]), _cuda.stream())
    _cuda.check(err, "block1d_bwd_weight")
    weight_launches += 1
    return dw


class Block1DFunction(torch.autograd.Function):
    """K2 forward, K6 + K7 backward on CUDA; the plain versions on the CPU.
    ``weight`` is cast to x's type inside, so its gradient keeps the
    weight's own type (f32 dW for f32 master weights, as in JAX)."""

    @staticmethod
    def forward(ctx, x, mask, weight, bias, gamma, beta, groups, eps):
        ctx.groups, ctx.eps = groups, eps
        ctx.param_dtypes = [p.dtype for p in (weight, bias, gamma, beta)]
        if not x.is_cuda:
            ctx.save_for_backward(x, mask, weight, bias, gamma, beta)
            return block1d_plain(x, mask, weight, bias, gamma, beta,
                                 groups=groups, eps=eps)
        x, lengths, w, bias, gamma, beta = prepare_forward(
            x, mask, weight, bias, gamma, beta)
        out, y, stats = _block1d_cuda(x, lengths, w, bias, gamma, beta,
                                      groups, eps)
        ctx.save_for_backward(x, lengths, w, gamma, beta, y, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        if g.is_cuda:
            x, lengths, w, gamma, beta, y, stats = ctx.saved_tensors
            dx, dy, (dgam, dbet, db) = block1d_bwd_data(
                x, lengths, w, gamma, beta, y, stats,
                g.to(x.dtype).contiguous(), groups=ctx.groups, eps=ctx.eps)
            dw = block1d_bwd_weight(x, lengths, dy)
        else:
            dx, dw, db, dgam, dbet = block1d_backward_plain(
                *ctx.saved_tensors, g, groups=ctx.groups, eps=ctx.eps)
        dtypes = ctx.param_dtypes
        return (dx, None, dw.to(dtypes[0]), db.to(dtypes[1]),
                dgam.to(dtypes[2]), dbet.to(dtypes[3]), None, None)


def block1d(x, mask, weight, bias, gamma, beta, *, groups: int = 8,
            eps: float = 1e-5):
    """Fused ``mish(masked_group_norm(conv_k3(x * mask))) * mask``,
    differentiable in x, weight, bias, gamma and beta.

    Args:
        x: ``(B, T, Cin)`` activations in the compute dtype.
        mask: ``(B, T, 1)`` contiguous-prefix validity mask (every mask the
            UNet builds is one: length masks halved per level).
        weight: ``(Cout, Cin, 3)``, cast to x's dtype; bias ``(Cout,)``
            conv parameters.
        gamma, beta: ``(Cout,)`` GroupNorm affine, applied in f32.
    """
    return Block1DFunction.apply(x, mask, weight, bias, gamma, beta, groups,
                                 eps)
