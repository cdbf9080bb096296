"""Multi-head attention (counterpart of serenade_tpu/ops/attention.py).

Square self-attention (``tq == tk``) goes through the flash wrapper at
every length: the flash kernels on CUDA, their plain versions on the CPU.
The route is chosen by shape before anything is launched (in an
exported program, by the custom op when the program runs): a square
attention whose head dim or dtype a flash kernel does not take
(``flash_cuda.flash_supported``; bf16 at a head dim other than 256 and
512) takes the plain version, differentiated by autograd, and counts in
``flash_cuda.routed``; so does non-square attention (the GST token
attention, tq=1), uncounted, as ``_xla_attention`` does in JAX.  Padded
keys get a -1e30 bias and the softmax runs in f32.
:func:`seq_sharded_attention` is the context-parallel form over a rank
mesh's ``seq`` axis.
"""

from __future__ import annotations

from typing import Optional

import torch

from serenade_tpu_torch.ops import flash_cuda
from serenade_tpu_torch.ops.flash_cuda import (
    flash_attention,
    flash_attention_plain,
    flash_supported,
)


def multi_head_attention(q, k, v, *, num_heads: int,
                         key_mask: Optional[torch.Tensor] = None):
    """q ``(B, Tq, H*D)``, k/v ``(B, Tk, H*D)``, key_mask ``(B, Tk)``
    1=valid.  Returns ``(B, Tq, H*D)``."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    d = hd // num_heads
    scale = d ** -0.5

    def split(x, t):
        return x.reshape(b, t, num_heads, d).transpose(1, 2)

    qh, kh, vh = split(q, tq), split(k, tk), split(v, tk)
    # while a program is exported, square attention of every shape goes to
    # the custom op, which routes and counts a refused shape when the
    # program runs (a trace runs nothing)
    if tq == tk and (torch.compiler.is_exporting()
                     or flash_supported(tq, tk, d, q.dtype)):
        out = flash_attention(qh, kh, vh, key_mask, scale)
    else:
        if tq == tk:   # square, but a flash kernel does not take the shape
            flash_cuda.routed += 1
        out, _ = flash_attention_plain(qh, kh, vh, key_mask, scale)
    return out.transpose(1, 2).reshape(b, tq, hd)


def seq_sharded_attention(q, k, v, *, num_heads: int, mesh,
                          seq_axis: str = "seq",
                          key_mask: Optional[torch.Tensor] = None):
    """Context-parallel attention (``serenade_tpu/ops/attention.py:115``):
    ``q`` ``(B, Tq / n, H*D)`` is this rank's time slab of the queries on
    ``mesh``'s ``seq_axis`` (n ranks, slab ``i`` on rank ``i``), K, V and
    the key mask are whole on every rank.  Rows of attention are
    independent given K and V, so each rank runs the usual dispatch on its
    slab (a slab is not square, so it takes the plain route, uncounted, as
    JAX skips its flash kernel for slabs) and the slabs are all-gathered:
    returns ``(B, Tq, H*D)``, differentiable (the gradient keeps this
    rank's slab)."""
    from serenade_tpu_torch.parallel.comm import gather_from_group

    out = multi_head_attention(q, k, v, num_heads=num_heads,
                               key_mask=key_mask)
    return gather_from_group(out, mesh.group(seq_axis), dim=1)
