"""K3: HiFiGAN residual branch, CUDA kernels ``csrc/resblock_branch.cu``.

Replaces ``serenade_tpu/ops/resblock_pallas.py:154``
(``resblock_branch_pallas`` → ``_branch_kernel``).  Per dilation d:
lrelu(0.1) → dilated k-conv → [lrelu → k-conv] → +residual, with zeros
outside [0, T) before every conv.  The wrapper counts one launch per
branch.  f32 branches at C 16, 32, 64, 128 and 256 run on the tensor
cores by split TF32 (one kernel launch per conv, planned by ``k3_plan``,
the weights split into TF32 hi and lo parts once per weight version);
bf16 branches and other widths run the FMA kernel, one launch per
dilation stage.  CPU tensors run ``resblock_branch_plain`` (the conv chain
of ``HiFiGANResidualBlock``).  The Pallas kernel has no backward and
neither has this one: on CUDA the wrapper refuses inputs that need a
gradient, whose result would otherwise carry none.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from serenade_tpu_torch.ops.primitives import conv1d
from serenade_tpu_torch.ops import _cuda

launches = 0   # wrapper calls that launched the kernel since the last reset

SMEM_BUDGET = 200 * 1024   # bytes of dynamic shared memory per FMA block
MAX_TILE = 2048
MAX_TN = 256                # output channels per pass of the FMA kernel

# The split-TF32 kernel (k3::conv_tf32_kernel): columns a consumer
# warpgroup owns at each width C it takes (two warpgroups split C 256),
# the 64-row blocks it may own (accumulators and two sets of A fragments
# within the 168 registers a thread of 384 gets), 16 input channels a
# ring stage of hi and lo weight boxes, windows padded by 4 floats a row,
# 2 to 8 stages, and the card's 232,448 bytes of shared memory less 1 KB
# for static barriers.
K3_WN = {16: 16, 32: 32, 64: 64, 128: 128, 256: 128}
K3_MB = {16: (1, 2, 4), 32: (1, 2, 4), 64: (1, 2), 128: (1,)}
K3_KC = 16
K3_LD_PAD = 4
K3_STAGES = (2, 8)
K3_SMEM_LIMIT = 232448 - 1024


def resblock_branch_plain(x, w1, b1, w2, b2, *, kernel_size: int,
                          dilations: Tuple[int, ...],
                          use_additional_convs: bool = True):
    """x ``(B,T,C)``; w1/w2 ``(n_dil, C, C, K)`` in torch layout; b1/b2
    ``(n_dil, C)``; each stacked, or a sequence of its n_dil tensors."""
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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped
    bits' unit to the bit pattern and clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo): hi = x in TF32, lo = the rest in TF32; hi + lo keeps all
    but about 2^-22 of x."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def _group(p) -> tuple:
    """A branch parameter's tensors: a stacked ``(n_dil, ...)`` tensor, or
    the sequence of its n_dil per-dilation tensors."""
    return (p,) if torch.is_tensor(p) else tuple(p)


def _stacked(ps: tuple, rank: int) -> torch.Tensor:
    """A ``_group`` as one ``(n_dil, ...)`` tensor of ``rank`` dimensions."""
    return ps[0] if len(ps) == 1 and ps[0].dim() == rank else torch.stack(ps)


def _tf32_operands(*params):
    """The TF32 kernel's operands from the tensors of w1, w2, b1 and b2,
    four ``_group``s of one length: the weights ``(n_dil, 2, K, 2, Cout,
    Cin)`` f32 — conv1 then conv2, each tap's hi then lo part, Cin
    contiguous (K-major, as TF32 wgmma reads B) — and the biases
    ``(n_dil, C)`` f32."""
    q = len(params) // 4
    w1, w2, b1, b2 = (_stacked(params[i * q:(i + 1) * q], rank)
                      for i, rank in enumerate((4, 4, 2, 2)))
    parts = []
    for w in (w1, w2):
        taps = w.float().permute(0, 3, 1, 2)             # (n, K, Cout, Cin)
        parts.append(torch.stack(tf32_split(taps), dim=2))
    return (torch.stack(parts, dim=1).contiguous(),
            b1.float().contiguous(), b2.float().contiguous())


# made once per version of the parameter tensors the wrapper is given
_TF32_OPERANDS = _cuda.VersionCache(_tf32_operands)


def tf32_operands(w1, b1, w2, b2):
    """(weights, b1, b2) of the TF32 kernel, made once per version of the
    given tensors (each parameter stacked or per dilation, as
    ``resblock_branch`` takes them)."""
    return _TF32_OPERANDS(*_group(w1), *_group(w2), *_group(b1),
                          *_group(b2))


def _pass_shape(c: int):
    """(columns, rows) of one pass of the FMA kernel's conv: 256 threads
    with 8 x 8 tiles over min(C, 256) columns.  None if C does not split
    so."""
    tn = min(c, MAX_TN)
    if tn % 8 or 256 % (tn // 8) or c % tn:
        return None
    return tn, 8 * (256 // (tn // 8))


def smem_bytes(c: int, k: int, d: int, add: bool, bt: int) -> int:
    """Shared memory of one FMA stage block: the f32 input window (tile
    plus both convs' halos) and the conv1 output window, rows padded to
    C + 1 floats, then a 16-row weight tile."""
    p1 = (k - 1) // 2 * d
    p2 = (k - 1) // 2 if add else 0
    windows = (bt + 2 * p2 + 2 * p1) * (c + 1)
    if add:
        windows += (bt + 2 * p2) * (c + 1)
    return ((windows + 3) // 4 * 4 + 16 * min(c, MAX_TN)) * 4


def tile_rows(c: int, k: int, d: int, add: bool) -> int:
    """Time rows per FMA block for one stage: the first conv computes
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


def tf32_smem_bytes(c: int, rows: int, stages: int) -> int:
    """Shared memory of a TF32 conv CTA: the weight ring, the window of
    ``rows`` padded rows and 1 KB to align the ring."""
    return stages * 2 * c * K3_KC * 4 + rows * (c + K3_LD_PAD) * 4 + 1024


def _conv_plan(b: int, t: int, c: int, k: int, dil: int, sm_count: int):
    """The TF32 kernel's launch of one conv, or None if no tile fits.  The
    candidates are the 64-row blocks a consumer may own; each is scored by
    a model of its makespan, waves x (max(BM, 120) + 2 p + 64): a CTA
    streams all of its k C / 16 weight stages whatever BM, which the
    tensor cores hide only from about 120 rows up (a stage feeds 0.75 BM
    FLOP a byte, where L2 gives about 90 a byte at full rate), and every
    CTA loads a window of BM + 2 p rows and fills and drains its pipeline.
    Ties go to the larger tile."""
    wn = K3_WN[c]
    ns = c // wn
    p = (k - 1) // 2 * dil
    best = None
    for mb in K3_MB[wn]:
        bm = 64 * mb * (2 // ns)
        rows = bm + 2 * p
        fixed = tf32_smem_bytes(c, rows, 0)
        stages = min(K3_STAGES[1],
                     (K3_SMEM_LIMIT - fixed) // (2 * c * K3_KC * 4))
        if stages < K3_STAGES[0]:
            continue
        tiles = -(-t // bm)
        ctas = b * tiles
        waves = -(-ctas // sm_count)
        est = waves * (max(bm, 120) + 2 * p + 64)
        if best is None or (est, -bm) < (best["est"], -best["bm"]):
            best = {"wn": wn, "mb": mb, "ns": ns, "bm": bm, "rows": rows,
                    "stages": stages, "grid": (tiles, b), "ctas": ctas,
                    "waves": waves, "est": est,
                    "smem_bytes": tf32_smem_bytes(c, rows, stages)}
    return best


@functools.lru_cache(maxsize=256)
def k3_plan(b: int, t: int, c: int, k: int, d: int, add: bool, dtype,
            sm_count: int) -> dict:
    """K3's launches for one dilation stage on a card of ``sm_count``
    multiprocessors, as the wrapper passes them to the kernels.

    ``route`` "tf32": f32 at C 16, 32, 64, 128 or 256 where a tile fits;
    ``convs`` holds conv1's launch (dilation d) and, with additional
    convs, conv2's (dilation 1): ``wn`` columns and ``mb`` 64-row blocks
    a consumer warpgroup owns, ``ns`` 2 when the two consumers split the
    columns (C 256) and 1 when they split the rows, ``bm`` rows a CTA,
    the grid (row tiles, batch), the ring's ``stages``, the dynamic shared
    memory and the model's score.
    ``route`` "fma": bf16, and f32 at other widths: one launch of the FMA
    kernel with ``tile_rows`` rows a block.  Raises ``ValueError`` on a
    width neither takes.  Cached: treat the result as read-only."""
    if dtype == torch.float32 and c in K3_WN:
        convs = [_conv_plan(b, t, c, k, d, sm_count)]
        if add:
            convs.append(_conv_plan(b, t, c, k, 1, sm_count))
        if all(convs):
            return {"route": "tf32", "convs": convs}
    _cuda.require(_pass_shape(c) is not None,
                  f"C {c}: min(C, 256) must be 8 x a power of two dividing C")
    bt = tile_rows(c, k, d, add)
    return {"route": "fma", "tile_rows": bt, "grid": (-(-t // bt), b),
            "smem_bytes": smem_bytes(c, k, d, add, bt)}


def _conv_tf32(fn, x, w, bias, res, out, k, dil, plan):
    b, t, c = x.shape
    err = fn(_cuda.ptr(x), _cuda.ptr(w), _cuda.ptr(bias),
             ctypes.c_void_p(None if res is None else res.data_ptr()),
             _cuda.ptr(out), ctypes.c_int(b), ctypes.c_int(t),
             ctypes.c_int(c), ctypes.c_int(k), ctypes.c_int(dil),
             ctypes.c_int(plan["wn"]), ctypes.c_int(plan["mb"]),
             ctypes.c_int(plan["ns"]), ctypes.c_int(plan["grid"][0]),
             ctypes.c_int(plan["stages"]), ctypes.c_int(plan["smem_bytes"]),
             _cuda.stream())
    _cuda.check(err, "resblock_conv_tf32")


def _branch_cuda(x, w1, b1, w2, b2, k, dilations, add):
    global launches
    b, t, c = x.shape
    n = len(dilations)
    dev = x.device
    _cuda.require(x.dtype in _cuda.DTYPE_CODE, f"dtype {x.dtype}")
    _cuda.require(x.is_contiguous(), "x must be contiguous (B, T, C)")
    groups = [_group(p) for p in (w1, b1, w2, b2)]
    _cuda.require(len({len(g) for g in groups}) == 1,
                  "w1, b1, w2, b2: each stacked, or each per dilation")
    for name, ws in (("w1", groups[0]), ("w2", groups[2])):
        shape = (tuple(ws[0].shape) if ws[0].dim() == 4
                 else (len(ws), *ws[0].shape))
        _cuda.require(shape == (n, c, c, k)
                      and all(w.device == dev for w in ws),
                      f"{name} {shape} != {(n, c, c, k)} on {dev}")
    sms = _cuda.sm_count(dev)
    plans = [k3_plan(b, t, c, k, d, add, x.dtype, sms) for d in dilations]
    h = x
    if plans[0]["route"] == "tf32":
        wp, b1f, b2f = tf32_operands(w1, b1, w2, b2)
        fn = _cuda.library("resblock_branch").serenade_resblock_conv_tf32
        fn.restype = ctypes.c_int
        mid = torch.empty_like(x) if add else None
        for i, (d, plan) in enumerate(zip(dilations, plans)):
            out = torch.empty_like(x)
            if add:
                _conv_tf32(fn, h, wp[i, 0], b1f[i], None, mid, k, d,
                           plan["convs"][0])
                _conv_tf32(fn, mid, wp[i, 1], b2f[i], h, out, k, 1,
                           plan["convs"][1])
            else:
                _conv_tf32(fn, h, wp[i, 0], b1f[i], h, out, k, d,
                           plan["convs"][0])
            h = out
    else:
        # the FMA kernel reads taps as (n, K, Cin, Cout): Cout contiguous
        w1t, w2t = (_stacked(_group(w), 4).to(x.dtype).permute(0, 3, 2, 1)
                    .contiguous() for w in (w1, w2))
        b1f, b2f = (_stacked(_group(p), 2).float().contiguous()
                    for p in (b1, b2))
        fn = _cuda.library("resblock_branch").serenade_resblock_stage
        fn.restype = ctypes.c_int
        for i, (d, plan) in enumerate(zip(dilations, plans)):
            out = torch.empty_like(x)
            err = fn(_cuda.ptr(h), _cuda.ptr(w1t[i]), _cuda.ptr(b1f[i]),
                     _cuda.ptr(w2t[i]), _cuda.ptr(b2f[i]), _cuda.ptr(out),
                     ctypes.c_int(b), ctypes.c_int(t), ctypes.c_int(c),
                     ctypes.c_int(k), ctypes.c_int(d), ctypes.c_int(int(add)),
                     ctypes.c_int(plan["tile_rows"]),
                     ctypes.c_int(plan["smem_bytes"]),
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
    without additional convs); b1/b2: ``(n_dil, C)``.  Each may also be
    given as the sequence of its n_dil per-dilation tensors, as
    ``HiFiGANResidualBlock`` passes its parameters.  On CUDA the f32 kernel
    splits the weights once per version of the tensors given
    (``tf32_operands``): pass the same tensors from call to call.  While a
    program is exported, the branch goes through the custom op
    ``serenade::resblock_branch`` (``ops/custom_ops.py``), which it can
    hold.
    """
    assert kernel_size % 2 == 1
    if torch.compiler.is_exporting():
        from serenade_tpu_torch.ops import custom_ops

        return custom_ops.resblock_branch(
            x, *(list(_group(p)) for p in (w1, b1, w2, b2)), kernel_size,
            list(dilations), use_additional_convs)
    if not x.is_cuda:
        w1, w2 = (_stacked(_group(w), 4).to(x.dtype) for w in (w1, w2))
        b1, b2 = (_stacked(_group(p), 2).to(x.dtype) for p in (b1, b2))
        return resblock_branch_plain(
            x, w1, b1, w2, b2, kernel_size=kernel_size, dilations=dilations,
            use_additional_convs=use_additional_convs)
    if torch.is_grad_enabled() and any(
            t.requires_grad for p in (x, w1, b1, w2, b2) for t in _group(p)):
        raise RuntimeError(
            "resblock_branch: the CUDA kernel has no backward; run it under "
            "torch.no_grad() or with inputs that need no gradient")
    return _branch_cuda(x.contiguous(), w1, b1, w2, b2, kernel_size,
                        tuple(dilations), use_additional_convs)
