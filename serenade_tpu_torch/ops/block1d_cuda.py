"""Fused Block1D with its backward: CUDA kernels ``csrc/block1d_fwd.cu``
(K2) and ``csrc/block1d_bwd.cu`` (K6, K7).

- K2 replaces ``serenade_tpu/ops/block1d_pallas.py:255``
  (``_fused_block1d_fwd`` → ``_fwd_kernel``):
  ``mish(masked_group_norm(conv_k3(x·mask)))·mask`` with prefix masks.
  One wrapper call launches two kernels (conv + bias + per-group
  statistics, then normalize + affine + Mish + mask) and counts as one
  launch.  In bf16 the conv runs on Hopper's wgmma as ``k2_plan`` lays it
  out, from the weight's taps laid out once per weight version
  (``k2_taps``).
- K6 replaces ``block1d_pallas.py:296`` (``_bwd_data_kernel``): Mish′,
  the GroupNorm backward, dγ, dβ, dbias and dx by the transposed taps.
  In bf16 dx runs on Hopper's wgmma as ``k6_plan`` lays it out, reading
  K2's taps (``k2_taps``) transposed, tap 2 - j for step j.
- K7 replaces ``block1d_pallas.py:343`` (``_bwd_w_kernel``): dW, reduced
  over batch and time.

``block1d`` goes through ``Block1DFunction`` where
``block1d_cuda_supported`` takes the shape, and otherwise through
``block1d_plain`` differentiated by autograd, counted in ``routed``: the
route is chosen by shape before anything is launched.  On CUDA the
forward keeps K2's f32 conv output y and f64 group sums for K6, where the Pallas
backward recomputes them.  CPU tensors run ``block1d_plain`` (conv1d +
two-pass ``masked_group_norm`` + mish, the unfused JAX ``Block1D``) and
``block1d_backward_plain`` (the Pallas backward's formulas step by step;
K7's part alone is ``block1d_weight_grad_plain``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from serenade_tpu_torch.ops.primitives import (
    accum_dtype,
    conv1d,
    masked_group_norm,
    mish,
)
from serenade_tpu_torch.ops import _cuda

# wrapper calls that launched each kernel since the last reset: K2, K6, K7;
# and the Block1Ds ``block1d`` routed to the plain version because a kernel
# of the three does not take their shape
launches = 0
data_launches = 0
weight_launches = 0
routed = 0


def block1d_cuda_supported(b: int, t: int, cin: int, cout: int, groups: int,
                           dtype) -> bool:
    """Whether K2 and its backward K6, K7 all take this shape: Cout in
    ``groups`` groups and a multiple of 4 (the normalize pass writes four
    channels at once), and in bf16 an even Cin (x rows load by 4-byte
    ``cp.async`` or TMA) and Cout a multiple of 8 (dy and the taps load by
    TMA).  The planners refuse what this rejects, and JAX likewise takes
    its unfused Block1D where ``block1d_supported`` says no
    (``serenade_tpu/models/unet.py``)."""
    if cout % groups or cout % 4:
        return False
    return dtype != torch.bfloat16 or (cin % 2 == 0 and cout % 8 == 0)


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


# K2's bf16 kernel: a CTA per 64 time rows x 2 WN output channels (WN 64
# or 32 a consumer warpgroup), a ring of stages of 64 input channels: x
# boxes of 64 rows for three taps and each tap's 2 WN weight rows, 128
# bytes a row.  The C entry checks a plan against the kernel's constants
# and refuses one that does not match them.
K2_ROWS = 64
K2_WN = (64, 32)
K2_MAX_STAGES = 6
# least stages a ring may have, by x's loader: the cp.async producer
# completes a stage only after it has waited for the next one's slot
K2_MIN_STAGES = {"tma": 2, "cp.async": 3}
# the card's 232,448 bytes less 4 KB for the static barriers and sums
K2_SMEM_LIMIT = 232448 - 4096


def k2_stage_bytes(wn: int) -> int:
    return 3 * K2_ROWS * 128 + 3 * 2 * wn * 128


@functools.lru_cache(maxsize=64)
def k2_plan(b: int, t: int, cin: int, cout: int, dtype,
            sm_count: int) -> dict:
    """K2's conv launch for a shape and a card of ``sm_count``
    multiprocessors, as the wrapper passes it to the kernel: the columns
    ``wn`` a consumer warpgroup owns, the grid (64-row tiles, Cout tiles,
    batch), the ring's stages, the dynamic shared memory and how x is
    loaded.  bf16 runs one CTA per SM; of WN 64 and 32 it takes the one
    with the shorter makespan, waves x 2 WN (a CTA's work grows with its
    columns), the larger on a tie: 96 CTAs at batch 1, T 1536, Cout 512,
    and WN 32 (96 CTAs, not 48) at T 768.  No split of the 3 Cin depth:
    the statistics need whole conv outputs.  f32 runs 64 x 64 FMA tiles.
    Raises ``ValueError`` on a bf16 shape the Hopper kernel does not take.
    Cached: treat the result as read-only."""
    tiles = -(-t // K2_ROWS)
    if dtype != torch.bfloat16:
        return {"wn": 0, "grid": (tiles, -(-cout // 64), b), "ctas": None,
                "stages": 0, "smem_bytes": 0, "x_loader": "plain"}
    _cuda.require(cin % 2 == 0, f"bf16 Block1D: Cin {cin} must be even (x "
                  "rows load by 4-byte cp.async or TMA)")
    best = None
    for wn in K2_WN:
        ctas = tiles * -(-cout // (2 * wn)) * b
        est = -(-ctas // sm_count) * 2 * wn
        if best is None or est < best[0]:
            best = (est, wn, ctas)
    _, wn, ctas = best
    stages = min(K2_MAX_STAGES, (K2_SMEM_LIMIT - 1024) // k2_stage_bytes(wn))
    loader = "tma" if cin % 8 == 0 else "cp.async"
    _cuda.require(stages >= K2_MIN_STAGES[loader],
                  f"K2: {stages} stages of {loader} loads would deadlock")
    return {"wn": wn, "grid": (tiles, -(-cout // (2 * wn)), b), "ctas": ctas,
            "stages": stages,
            "smem_bytes": stages * k2_stage_bytes(wn) + 1024,
            "x_loader": loader}


def _k2_taps(weight):
    """K2's bf16 weight: ``(3, Cout, Cin8)``, each tap's (Cout, Cin) with
    Cin contiguous (K2's B K-major, K6's B MN-major) and padded with zeros
    to a multiple of 8 (TMA's 16-byte rows)."""
    taps = weight.to(torch.bfloat16).permute(2, 0, 1)
    return F.pad(taps, (0, -weight.shape[1] % 8)).contiguous()


# made once per version of the weight it is given
k2_taps = _cuda.VersionCache(_k2_taps)


def _block1d_cuda(x, lengths, weight, bias, gamma, beta, groups, eps, *,
                  taps=None):
    """K2.  Returns (out, y, stats): y the f32 conv output, stats the f64
    per-(sample, group) sum and sum of squares over valid frames.  bf16
    reads ``taps`` (``k2_taps`` of the weight; made from ``weight`` when
    not given)."""
    global launches
    b, t, cin = x.shape
    cout = weight.shape[0]
    dev = x.device
    _check_params(x, weight, {"bias": bias, "gamma": gamma, "beta": beta},
                  groups)
    plan = k2_plan(b, t, cin, cout, x.dtype, _cuda.sm_count(dev))
    if x.dtype == torch.bfloat16:
        _cuda.require(x.data_ptr() % 16 == 0,
                      "bf16 Block1D: x must be 16-byte aligned (TMA)")
        taps = k2_taps(weight) if taps is None else taps
        _cuda.require(taps.shape == (3, cout, cin + -cin % 8)
                      and taps.dtype == torch.bfloat16
                      and taps.is_contiguous() and taps.device == dev,
                      f"taps {tuple(taps.shape)} {taps.dtype}")
    y = torch.empty((b, t, cout), dtype=torch.float32, device=dev)
    stats = torch.zeros((b, groups, 2), dtype=torch.float64, device=dev)
    out = torch.empty((b, t, cout), dtype=x.dtype, device=dev)
    fn = _cuda.library("block1d_fwd").serenade_block1d_fwd
    fn.restype = ctypes.c_int
    grid_x, grid_y, _ = plan["grid"]
    err = fn(_cuda.ptr(x), _cuda.ptr(lengths), _cuda.ptr(weight),
             ctypes.c_void_p(None if taps is None else taps.data_ptr()),
             _cuda.ptr(bias), _cuda.ptr(gamma), _cuda.ptr(beta),
             _cuda.ptr(y), _cuda.ptr(stats), _cuda.ptr(out),
             ctypes.c_int(b), ctypes.c_int(t), ctypes.c_int(cin),
             ctypes.c_int(cout), ctypes.c_int(groups), ctypes.c_float(eps),
             ctypes.c_int(plan["wn"]), ctypes.c_int(grid_x),
             ctypes.c_int(grid_y), ctypes.c_int(plan["stages"]),
             ctypes.c_int(plan["smem_bytes"]),
             ctypes.c_int(plan["x_loader"] == "tma"),
             ctypes.c_int(_cuda.DTYPE_CODE[x.dtype]), _cuda.stream())
    _cuda.check(err, "block1d_fwd")
    launches += 1
    return out, y, stats


# K7's bf16 kernel: a CTA per (128 Cout x 64 Cin) tile and split of the
# 64-row time tiles, a ring of 4 stages of five 64 x 64 bf16 boxes (dy for
# two consumer warpgroups, x for three taps) and 1 KB for its alignment.
# The C entry checks a plan against the kernel's own constants and
# refuses one that does not match them.
K7_TILE = {torch.bfloat16: (128, 64), torch.float32: (64, 64)}
K7_ROWS = 64
K7_BF16_SMEM = 4 * 5 * 64 * 128 + 1024
K7_MAX_SPLITS = 512


@functools.lru_cache(maxsize=64)
def k7_plan(b: int, t: int, cin: int, cout: int, dtype,
            sm_count: int) -> dict:
    """K7's launch for a shape and a card of ``sm_count`` multiprocessors,
    as the wrapper passes it to the kernel: the grid (Cout tiles, Cin
    tiles, splits), ``bounds`` (split z takes the 64-row time tiles
    ``bounds[z]`` to ``bounds[z + 1]``; tile i is sample ``i // tps``,
    rows ``64 (i % tps)`` onward), the dynamic shared memory and how x is
    loaded.  bf16 runs one CTA per SM (its ring takes 165 KB), so the
    split fills one wave; f32 aims at about four waves of its 64 x 64
    blocks.  Raises ``ValueError`` on a bf16 shape the Hopper kernel does
    not take.  Cached: treat the result as read-only."""
    bco, bci = K7_TILE[dtype]
    tiles = b * -(-t // K7_ROWS)
    out_tiles = -(-cout // bco) * -(-cin // bci)
    if dtype == torch.bfloat16:
        _cuda.require(cin % 2 == 0, f"bf16 dW: Cin {cin} must be even (x "
                      "rows load by 4-byte cp.async or TMA)")
        _cuda.require(cout % 8 == 0, f"bf16 dW: Cout {cout} must be a "
                      "multiple of 8 (dy rows load by TMA)")
        waves, smem = 1, K7_BF16_SMEM
        loader = "tma" if cin % 8 == 0 else "cp.async"
    else:
        waves, smem, loader = 4, 0, "plain"
    splits = max(1, min(tiles, K7_MAX_SPLITS, waves * sm_count // out_tiles))
    bounds = tuple(z * tiles // splits for z in range(splits + 1))
    return {"grid": (-(-cout // bco), -(-cin // bci), splits),
            "splits": splits, "time_tiles": tiles, "bounds": bounds,
            "bounds_c": (ctypes.c_int * (splits + 1))(*bounds),
            "smem_bytes": smem, "x_loader": loader}


# K6's bf16 dx kernel: a CTA per 128 time rows x BN input channels (BN 256
# or 128), a ring of (64-channel chunk, tap) stages: one tap's 128-row dy
# box and 64 rows of BN Cin values of K2's taps, 128 bytes a row.  The C
# entry checks a plan against the kernel's constants and refuses one that
# does not match.
K6_ROWS = 128
K6_BN = (256, 128)
K6_MAX_STAGES = 8
# the card's 232,448 bytes less 1 KB for the static barriers
K6_SMEM_LIMIT = 232448 - 1024


def k6_stage_bytes(bn: int) -> int:
    return K6_ROWS * 128 + bn * 128


@functools.lru_cache(maxsize=64)
def k6_plan(b: int, t: int, cin: int, cout: int, dtype,
            sm_count: int) -> dict:
    """K6's dx launch for a shape and a card of ``sm_count``
    multiprocessors, as ``block1d_bwd_data`` passes it to the kernel: the
    input channels ``bn`` a CTA owns, the grid (128-row tiles, Cin tiles,
    batch), the ring's stages and the dynamic shared memory.  bf16 runs
    one CTA per SM; of BN 256 and 128 it takes the one with the shorter
    makespan, waves x BN (a CTA's work grows with its columns), the larger
    on a tie: BN 256 at (16, 512, 1024) (256 CTAs), BN 128 at (16, 512,
    242) and (16, 256, 512) (128 CTAs, not 64).  f32 runs 64 x 64 FMA
    tiles.  Raises ``ValueError`` on a bf16 shape the Hopper kernel does
    not take.  Cached: treat the result as read-only."""
    if dtype != torch.bfloat16:
        return {"bn": 0, "grid": (-(-t // 64), -(-cin // 64), b),
                "ctas": None, "stages": 0, "smem_bytes": 0}
    _cuda.require(cin % 2 == 0, f"bf16 dx: Cin {cin} must be even (dx "
                  "stores pairs of channels)")
    _cuda.require(cout % 8 == 0, f"bf16 dx: Cout {cout} must be a multiple "
                  "of 8 (dy and the taps load by TMA)")
    tiles = -(-t // K6_ROWS)
    best = None
    for bn in K6_BN:
        ctas = tiles * -(-cin // bn) * b
        est = -(-ctas // sm_count) * bn
        if best is None or est < best[0]:
            best = (est, bn, ctas)
    _, bn, ctas = best
    stages = min(K6_MAX_STAGES, (K6_SMEM_LIMIT - 1024) // k6_stage_bytes(bn))
    return {"bn": bn, "grid": (tiles, -(-cin // bn), b), "ctas": ctas,
            "stages": stages,
            "smem_bytes": stages * k6_stage_bytes(bn) + 1024}


def block1d_bwd_data(x, lengths, weight, gamma, beta, y, stats, g, *,
                     groups: int = 8, eps: float = 1e-5, taps=None):
    """K6 (three kernels, one launch count).  ``weight`` in x's type, y and
    stats from K2; bf16 reads ``taps``, the ``k2_taps`` K2 read in the
    forward (made from ``weight`` when not given), as its dx product's B
    transposed.  Returns (dx, dy in x's type, (3, Cout) f32 rows dgamma,
    dbeta, dbias)."""
    global data_launches
    b, t, cin = x.shape
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
    plan = k6_plan(b, t, cin, cout, x.dtype, _cuda.sm_count(dev))
    if x.dtype == torch.bfloat16:
        taps = k2_taps(weight) if taps is None else taps
        _cuda.require(taps.shape == (3, cout, cin + -cin % 8)
                      and taps.dtype == torch.bfloat16
                      and taps.is_contiguous() and taps.device == dev,
                      f"taps {tuple(taps.shape)} {taps.dtype}")
    else:
        taps = None
    gsum = torch.zeros((b, groups, 2), dtype=torch.float64, device=dev)
    dx = torch.empty_like(x)
    dy = torch.empty((b, t, cout), dtype=x.dtype, device=dev)
    dparams = torch.zeros((3, cout), dtype=torch.float32, device=dev)
    fn = _cuda.library("block1d_bwd").serenade_block1d_bwd_data
    fn.restype = ctypes.c_int
    grid_x, grid_y, _ = plan["grid"]
    err = fn(_cuda.ptr(lengths), _cuda.ptr(weight),
             ctypes.c_void_p(None if taps is None else taps.data_ptr()),
             _cuda.ptr(y), _cuda.ptr(stats), _cuda.ptr(gamma),
             _cuda.ptr(beta), _cuda.ptr(g), _cuda.ptr(gsum), _cuda.ptr(dx),
             _cuda.ptr(dy), _cuda.ptr(dparams), ctypes.c_int(b),
             ctypes.c_int(t), ctypes.c_int(cin), ctypes.c_int(cout),
             ctypes.c_int(groups), ctypes.c_float(eps),
             ctypes.c_int(plan["bn"]), ctypes.c_int(grid_x),
             ctypes.c_int(grid_y), ctypes.c_int(plan["stages"]),
             ctypes.c_int(plan["smem_bytes"]),
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
    _cuda.require(x.dtype != torch.bfloat16 or (
        x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0),
        "bf16 dW: x and dy must be 16-byte aligned (TMA)")
    _cuda.require(dy.shape == (b, t, cout) and dy.dtype == x.dtype
                  and dy.is_contiguous() and dy.device == dev,
                  f"dy {tuple(dy.shape)} {dy.dtype}")
    _cuda.require(lengths.shape == (b,) and lengths.dtype == torch.int32
                  and lengths.device == dev, "lengths must be int32 (B,)")
    plan = k7_plan(b, t, cin, cout, x.dtype, _cuda.sm_count(dev))
    grid_x, grid_y, splits = plan["grid"]
    dw = torch.zeros((cout, cin, 3), dtype=torch.float32, device=dev)
    fn = _cuda.library("block1d_bwd").serenade_block1d_bwd_weight
    fn.restype = ctypes.c_int
    err = fn(_cuda.ptr(x), _cuda.ptr(lengths), _cuda.ptr(dy), _cuda.ptr(dw),
             ctypes.c_int(b), ctypes.c_int(t), ctypes.c_int(cin),
             ctypes.c_int(cout), ctypes.c_int(grid_x), ctypes.c_int(grid_y),
             ctypes.c_int(splits), plan["bounds_c"],
             ctypes.c_int(plan["smem_bytes"]),
             ctypes.c_int(plan["x_loader"] == "tma"),
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
        taps = k2_taps(weight) if x.dtype == torch.bfloat16 else None
        out, y, stats = _block1d_cuda(x, lengths, w, bias, gamma, beta,
                                      groups, eps, taps=taps)
        # K6 reads K2's taps of this weight version too
        ctx.save_for_backward(x, lengths, w, gamma, beta, y, stats, taps)
        return out

    @staticmethod
    def backward(ctx, g):
        if g.is_cuda:
            x, lengths, w, gamma, beta, y, stats, taps = ctx.saved_tensors
            dx, dy, (dgam, dbet, db) = block1d_bwd_data(
                x, lengths, w, gamma, beta, y, stats,
                g.to(x.dtype).contiguous(), groups=ctx.groups, eps=ctx.eps,
                taps=taps)
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

    While a program is exported, every shape goes through the custom op
    ``serenade::block1d_fwd`` (``ops/custom_ops.py``), which it can hold
    and which routes and counts a refused shape when the program runs.
    """
    global routed
    if torch.compiler.is_exporting():
        from serenade_tpu_torch.ops import custom_ops

        return custom_ops.block1d_fwd(x, mask, weight, bias, gamma, beta,
                                      groups, eps)
    b, t, cin = x.shape
    if block1d_cuda_supported(b, t, cin, weight.shape[0], groups, x.dtype):
        return Block1DFunction.apply(x, mask, weight, bias, gamma, beta,
                                     groups, eps)
    routed += 1
    return block1d_plain(x, mask, weight, bias, gamma, beta, groups=groups,
                         eps=eps)
