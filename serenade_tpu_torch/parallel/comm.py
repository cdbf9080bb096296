"""Collectives over a ``torch.distributed`` group, plain and differentiable.

JAX gets these from GSPMD and ``shard_map``; the port calls them itself.
Every function takes the caller's group; a group of None (an axis of one
rank) makes each of them the identity.

The differentiable ones are ``torch.autograd.Function``s:

* :func:`copy_to_group` (Megatron's *f*): identity forward, all-reduce of
  the gradient backward;
* :func:`reduce_from_group` (*g*): all-reduce forward, identity backward.
  This is ``lax.psum`` where every rank goes on with the same value: the
  upstream gradient is then the same on every rank already, so summing it
  again (``torch.distributed.nn.functional.all_reduce`` does) would scale
  the gradients by the group size;
* :func:`gather_from_group`: all-gather along a dimension; backward keeps
  this rank's slice (the gradient of the gathered tensor is the same on
  every rank);
* :func:`ring_shift`: rank ``i`` receives rank ``i - shift``'s tensor
  (``lax.ppermute`` over a ring); backward shifts the gradient back;
* :func:`all_to_all`: equal splits of dimension 0 exchanged; backward is
  the same exchange, which inverts it.

Gloo's support for CUDA tensors differs from collective to collective:
with torch 2.11+cu128 on an H100 its all-reduce, reduce-scatter,
all-gather and all-to-all take them, and its send/recv fail on them
("writev: Bad address").  So the ring shift, on a gloo group, copies its
CUDA tensors through the host, explicitly, and adds the bytes to
``staged_bytes``; NCCL groups and CPU tensors never stage.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

# bytes the ring shift copied device -> host -> device for gloo since the
# last reset
staged_bytes = 0

_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place over ``group``; returns it."""
    if group is not None:
        dist.all_reduce(t, _OPS[op], group=group)
    return t


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``t``'s ``rank``-th part of dimension 0
    (``t.shape[0]`` a multiple of the group's size)."""
    n = size(group)
    if n == 1:
        return t
    out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _SCATTER(out, t.contiguous(), group=group)
    return out


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dimension 0, in rank order."""
    n = size(group)
    if n == 1:
        return t
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _GATHER(out, t.contiguous(), group=group)
    return out


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    src = t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


def _shift(t: torch.Tensor, group, shift: int) -> torch.Tensor:
    n, r = size(group), rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src_rank = dist.get_global_rank(group, (r - shift) % n)
    src = t.contiguous()
    # gloo's send/recv take no CUDA tensors: through the host, counted
    staged = src.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        global staged_bytes
        staged_bytes += src.numel() * src.element_size()
        src = src.cpu()
    out = torch.empty_like(src)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, dst, group),
        dist.P2POp(dist.irecv, out, src_rank, group)])
    for req in reqs:
        req.wait()
    return out.to(t.device) if staged else out


# --- splitting a dimension into rank parts ---------------------------------


def _parts_view(t: torch.Tensor, dim: int, n: int, parts: int):
    """``t`` with dimension ``dim`` as (parts, n, c): ``parts`` equal
    pieces (tensors stacked from several flax leaves), each split ``n``
    ways."""
    length = t.shape[dim]
    if length % (parts * n):
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split {parts} x {n} ways")
    c = length // (parts * n)
    return t.reshape(t.shape[:dim] + (parts, n, c) + t.shape[dim + 1:])


def shard_of(t: torch.Tensor, dim: int, n: int, index: int,
             parts: int = 1) -> torch.Tensor:
    """Rank ``index``'s shard of ``t`` along ``dim``: its ``1/n`` of each of
    the dimension's ``parts`` pieces, in order."""
    if n == 1:
        return t
    v = _parts_view(t, dim, n, parts).select(dim + 1, index)
    return v.reshape(t.shape[:dim] + (-1,) + t.shape[dim + 1:])


def _by_rank(t: torch.Tensor, dim: int, n: int, parts: int) -> torch.Tensor:
    """``t`` laid out as n rank shards one after another (dimension 0)."""
    return _parts_view(t, dim, n, parts).movedim(dim + 1, 0).contiguous()


def _join(flat: torch.Tensor, shard_shape, dim: int, n: int,
          parts: int) -> torch.Tensor:
    """The inverse of :func:`_by_rank`: n rank shards back into one."""
    c = shard_shape[dim] // parts
    v = flat.reshape((n,) + tuple(shard_shape[:dim]) + (parts, c)
                     + tuple(shard_shape[dim + 1:]))
    v = v.movedim(0, dim + 1)
    return v.reshape(tuple(shard_shape[:dim]) + (parts * n * c,)
                     + tuple(shard_shape[dim + 1:]))


def gather_dim(t: torch.Tensor, group, dim: int,
               parts: int = 1) -> torch.Tensor:
    """Every rank's shard of ``group`` (:func:`shard_of`) joined along
    ``dim``: the full tensor."""
    n = size(group)
    if n == 1:
        return t
    return _join(all_gather(t.reshape(1, -1), group), t.shape, dim, n, parts)


# --- differentiable collectives --------------------------------------------


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, parts):
        ctx.args = (group, dim, parts)
        return gather_dim(x, group, dim, parts)

    @staticmethod
    def backward(ctx, g):
        group, dim, parts = ctx.args
        return (shard_of(g, dim, size(group), rank(group), parts),
                None, None, None)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.args = (group, shift)
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        group, shift = ctx.args
        return _shift(g, group, -shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: identity; the gradient is summed over ``group``."""
    return x if size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g* (``lax.psum`` with a replicated result): the sum over
    ``group``; the gradient passes through unchanged."""
    return x if size(group) == 1 else _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int = 0,
                      parts: int = 1) -> torch.Tensor:
    """The shards of ``group`` joined along ``dim``; the gradient keeps
    this rank's slice."""
    if size(group) == 1:
        return x
    return _GatherFromGroup.apply(x, group, dim, parts)


def ring_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank ``i`` of ``group`` gets rank ``i - shift``'s ``x``."""
    if size(group) == 1:
        return x
    return _RingShift.apply(x, group, shift)


def all_to_all(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Part ``j`` of dimension 0 goes to rank ``j``; part ``i`` of the
    result came from rank ``i``."""
    if size(group) == 1:
        return x
    return _AllToAll.apply(x, group)
