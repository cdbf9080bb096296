"""K3: HiFiGAN residual branch, CUDA kernel ``csrc/resblock_branch.cu``.

Replaces ``serenade_tpu/ops/resblock_pallas.py:154``
(``resblock_branch_pallas`` → ``_branch_kernel``).  Per dilation d:
lrelu(0.1) → dilated k-conv → [lrelu → k-conv] → +residual, with zeros
outside [0, T) before every conv.  The wrapper launches the kernel once
per dilation stage and counts one launch per branch.  CPU tensors run
``resblock_branch_plain`` (the conv chain of ``HiFiGANResidualBlock``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from serenade_tpu_torch.models.layers import conv1d
from serenade_tpu_torch.ops import _cuda

launches = 0   # wrapper calls that launched the kernel since the last reset

SMEM_BUDGET = 200 * 1024   # bytes of dynamic shared memory per block
MAX_TILE = 2048
MAX_TN = 256                # output channels per pass of the kernel


def resblock_branch_plain(x, w1, b1, w2, b2, *, kernel_size: int,
                          dilations: Tuple[int, ...],
                          use_additional_convs: bool = True):
    """x ``(B,T,C)``; w1/w2 ``(n_dil, C, C, K)`` in torch layout; b1/b2
    ``(n_dil, C)``."""
    k = kernel_size
    h = x
    for i, d in enumerate(dilations):
        o = conv1d(F.leaky_relu(h, 0.1), w1[i], b1[i], dilation=d,
                   padding=((k - 1) // 2 * d,) * 2)
        if use_additional_convs:
            o = conv1d(F.leaky_relu(o, 0.1), w2[i], b2[i],
                       padding=((k - 1) // 2,) * 2)
        h = h + o
    return h


def _pass_shape(c: int):
    """(columns, rows) of one pass of the kernel's conv: 256 threads with
    8 x 8 tiles over min(C, 256) columns.  None if C does not split so."""
    tn = min(c, MAX_TN)
    if tn % 8 or 256 % (tn // 8) or c % tn:
        return None
    return tn, 8 * (256 // (tn // 8))


def smem_bytes(c: int, k: int, d: int, add: bool, bt: int) -> int:
    """Shared memory of one stage block: the f32 input window (tile plus
    both convs' halos) and the conv1 output window, rows padded to C + 1
    floats, then a 16-row weight tile."""
    p1 = (k - 1) // 2 * d
    p2 = (k - 1) // 2 if add else 0
    windows = (bt + 2 * p2 + 2 * p1) * (c + 1)
    if add:
        windows += (bt + 2 * p2) * (c + 1)
    return ((windows + 3) // 4 * 4 + 16 * min(c, MAX_TN)) * 4


def tile_rows(c: int, k: int, d: int, add: bool) -> int:
    """Time rows per block for one stage: the first conv computes
    BT + 2 p2 rows, so BT = n * (rows of a pass) - 2 p2 with the largest n
    that fits SMEM_BUDGET; else the largest multiple of 16 that fits."""
    tm = _pass_shape(c)[1]
    p2 = (k - 1) // 2 if add else 0
    best = 0
    for n in range(1, MAX_TILE // tm + 2):
        bt = n * tm - 2 * p2
        if bt > MAX_TILE or smem_bytes(c, k, d, add, bt) > SMEM_BUDGET:
            break
        if bt > 0:
            best = bt
    if best:
        return best
    for bt in range(MAX_TILE, 0, -16):
        if smem_bytes(c, k, d, add, bt) <= SMEM_BUDGET:
            return bt
    raise ValueError(f"branch stage C={c} k={k} d={d} does not fit")


def _branch_cuda(x, w1, b1, w2, b2, k, dilations, add):
    global launches
    b, t, c = x.shape
    n = len(dilations)
    dev = x.device
    _cuda.require(x.dtype in _cuda.DTYPE_CODE, f"dtype {x.dtype}")
    _cuda.require(x.is_contiguous(), "x must be contiguous (B, T, C)")
    _cuda.require(_pass_shape(c) is not None,
                  f"C {c}: min(C, 256) must be 8 x a power of two dividing C")
    for name, w in (("w1", w1), ("w2", w2)):
        _cuda.require(w.shape == (n, c, c, k) and w.device == dev,
                      f"{name} {tuple(w.shape)} != {(n, c, c, k)}")
    # the kernel reads taps as (n, K, Cin, Cout): Cout contiguous
    w1t = w1.to(x.dtype).permute(0, 3, 2, 1).contiguous()
    w2t = w2.to(x.dtype).permute(0, 3, 2, 1).contiguous()
    b1f = b1.float().contiguous()
    b2f = b2.float().contiguous()
    fn = _cuda.library("resblock_branch").serenade_resblock_stage
    fn.restype = ctypes.c_int
    h = x
    for i, d in enumerate(dilations):
        bt = tile_rows(c, k, d, add)
        out = torch.empty_like(x)
        err = fn(_cuda.ptr(h), _cuda.ptr(w1t[i]), _cuda.ptr(b1f[i]),
                 _cuda.ptr(w2t[i]), _cuda.ptr(b2f[i]), _cuda.ptr(out),
                 ctypes.c_int(b), ctypes.c_int(t), ctypes.c_int(c),
                 ctypes.c_int(k), ctypes.c_int(d), ctypes.c_int(int(add)),
                 ctypes.c_int(bt), ctypes.c_int(smem_bytes(c, k, d, add, bt)),
                 ctypes.c_int(_cuda.DTYPE_CODE[x.dtype]), _cuda.stream())
        _cuda.check(err, "resblock_stage")
        h = out
    launches += 1
    return h


def resblock_branch(x, w1, b1, w2, b2, *, kernel_size: int,
                    dilations: Tuple[int, ...],
                    use_additional_convs: bool = True):
    """One HiFiGAN residual branch on ``(B, T, C)``.

    w1/w2: ``(n_dil, C, C, K)`` conv kernels in torch layout (w2 unused
    without additional convs); b1/b2: ``(n_dil, C)``.
    """
    assert kernel_size % 2 == 1
    if not x.is_cuda:
        return resblock_branch_plain(
            x, w1.to(x.dtype), b1.to(x.dtype), w2.to(x.dtype),
            b2.to(x.dtype), kernel_size=kernel_size, dilations=dilations,
            use_additional_convs=use_additional_convs)
    return _branch_cuda(x.contiguous(), w1, b1, w2, b2, kernel_size,
                        tuple(dilations), use_additional_convs)
