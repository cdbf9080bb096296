"""Parameter and optimizer-state sharding: tp and ZeRO-1 (counterpart of
serenade_tpu/parallel/sharding.py).

The rules are JAX's, read on the **flax layout's shape** of each tensor
(``convert.flax_leaf_shapes``: Dense ``(in, out)``, Conv ``(k, in, out)``;
the port's tensors are ``(out, in)`` and ``(out, in, k)``, so a rule on
torch shapes would pick other leaves and other axes):

* tp (:func:`_leaf_spec`): a leaf of at least ``1 << 16`` elements whose
  last (output-feature) dimension is at least 128 and divides by the
  ``model`` axis is split on that dimension;
* ZeRO-1 (:func:`_zero1_spec`): a moment of at least ``1 << 14`` elements
  is further split over ``data`` on its largest dimension that the rule
  left whole and that divides by the axis.

JAX states the placements and GSPMD inserts the collectives.  Here
:class:`ParallelLayout` runs them:

* tp keeps each rank's shard of every leaf the rule picks; the forward
  all-gathers the full weight (``comm.gather_from_group``) and the
  backward keeps this rank's slice of its gradient, the
  all-gather/reduce-scatter pair GSPMD makes.  Every kernel then runs at
  full width, unchanged (splitting the compute across the ``model``
  group is later work);
* dp all-reduces the gradients over the ``data`` group.  The models'
  masked means divide by the global batch's counts (``mesh.batch_sum``),
  so the sum of the ranks' gradients is the global batch's gradient;
* ZeRO-1 reduce-scatters the gradients of the split moments instead,
  clips by the global norm from the shards' squared sums, runs the masked
  AdamW on this rank's shard (moments in ``mu_dtype`` as always) and
  all-gathers the updated parameters.

Checkpoints hold the one-card layout: :meth:`ParallelLayout.full_params`
and :meth:`~ParallelLayout.full_opt_state` gather the shards, and
:meth:`~ParallelLayout.local_params` / :meth:`~ParallelLayout.
local_opt_state` cut a one-card state to this rank's shards, so a
checkpoint restores onto any layout and any world size.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from serenade_tpu_torch.convert import FlaxLeaf, flax_leaf_shapes
from serenade_tpu_torch.parallel import comm
from serenade_tpu_torch.parallel.mesh import Mesh, P, batch_shard, world

# don't split small tensors: the gather costs more than the memory it frees
MIN_SHARD_ELEMS = 1 << 16
MIN_ZERO1_ELEMS = 1 << 14


def _size(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _leaf_spec(shape: Tuple[int, ...], model_size: int) -> P:
    """JAX's tp rule on a flax leaf's shape."""
    if model_size <= 1 or len(shape) == 0:
        return P()
    last = shape[-1]
    if (_size(shape) >= MIN_SHARD_ELEMS and last % model_size == 0
            and last >= 128):
        return P(*([None] * (len(shape) - 1)), "model")
    return P()


def _zero1_spec(shape: Tuple[int, ...], data_size: int, model_size: int,
                data_axis: str = "data") -> P:
    """JAX's ZeRO-1 rule on a flax leaf's shape: the tp spec, plus
    ``data_axis`` on the largest still-whole dimension that divides."""
    if len(shape) == 0:
        return P()
    base = _leaf_spec(shape, model_size)
    if data_size <= 1:
        return base
    spec = list(base) + [None] * (len(shape) - len(base))
    if _size(shape) < MIN_ZERO1_ELEMS:
        return P(*spec)
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if spec[d] is None and shape[d] % data_size == 0:
            spec[d] = data_axis
            break
    return P(*spec)


def _port_split(leaf: FlaxLeaf, spec: P, axis: str):
    """(port dimension, parts) that ``spec`` splits over ``axis``, or
    None."""
    if axis not in spec:
        return None
    i = list(spec).index(axis)
    parts = leaf.parts if i == len(leaf.shape) - 1 else 1
    return leaf.axes[i], parts


def infer_param_shardings(model: nn.Module, mesh: Mesh) -> Dict[str, P]:
    """Each parameter name -> its tp spec on its flax leaf's axes."""
    m = mesh.axis_size("model")
    return {n: _leaf_spec(leaf.shape, m)
            for n, leaf in flax_leaf_shapes(model).items()}


def infer_opt_state_shardings(model: nn.Module, mesh: Mesh,
                              data_axis: str = "data") -> Dict[str, P]:
    """Each parameter name -> its moments' ZeRO-1 spec on its flax leaf's
    axes."""
    d, m = mesh.axis_size(data_axis), mesh.axis_size("model")
    return {n: _zero1_spec(leaf.shape, d, m, data_axis)
            for n, leaf in flax_leaf_shapes(model).items()}


class _GatherMany(torch.autograd.Function):
    """The full tensors of several tp shards in one all-gather; backward
    keeps this rank's slice of each gradient."""

    @staticmethod
    def forward(ctx, layout, *shards):
        ctx.layout = layout
        return tuple(layout._gather(layout.model_group, layout.tp, shards))

    @staticmethod
    def backward(ctx, *grads):
        lay = ctx.layout
        out = []
        for name, g in zip(lay.tp, grads):
            dim, parts = lay.tp[name]
            out.append(None if g is None else comm.shard_of(
                g, dim, lay.model_size, lay.model_index, parts))
        return (None, *out)


class ParallelLayout:
    """The dp × tp layout of one model on a ``('data', 'model')`` rank
    mesh, with ZeRO-1 optimizer state where ``zero1`` (and ``data`` > 1).

    ``tp`` and ``z1`` map the split parameter names to (port dimension,
    parts).  Build it before sharding (:func:`shard_params`), from the
    model with its full parameters."""

    def __init__(self, model: nn.Module, mesh: Mesh, *, zero1: bool = False):
        self.mesh = mesh
        self.data_size = mesh.axis_size("data")
        self.model_size = mesh.axis_size("model")
        self.data_group = mesh.group("data")
        self.model_group = mesh.group("model")
        self.data_index = mesh.axis_index("data")
        self.model_index = mesh.axis_index("model")
        self.tp: Dict[str, Tuple[int, int]] = {}
        self.z1: Dict[str, Tuple[int, int]] = {}
        for name, leaf in flax_leaf_shapes(model).items():
            hit = _port_split(leaf, _leaf_spec(leaf.shape, self.model_size),
                              "model")
            if hit:
                self.tp[name] = hit
            if zero1 and self.data_size > 1:
                hit = _port_split(leaf, _zero1_spec(
                    leaf.shape, self.data_size, self.model_size), "data")
                if hit:
                    self.z1[name] = hit
        self._owners = {n: model.get_submodule(n.rpartition(".")[0])
                        if "." in n else model for n in self.tp}

    @property
    def writer(self) -> bool:
        """Whether this rank writes checkpoints, logs and samples."""
        return world()[0] == 0

    def batch_shard(self, local_rows: int):
        return batch_shard(self.mesh, local_rows)

    # -- the split of one tensor -----------------------------------------

    def _tp_shard(self, name, t):
        dim, parts = self.tp[name]
        return comm.shard_of(t, dim, self.model_size, self.model_index, parts)

    def _z1_shard(self, name, t):
        dim, parts = self.z1[name]
        return comm.shard_of(t, dim, self.data_size, self.data_index, parts)

    def _gather(self, group, split, tensors):
        """The full tensors of ``tensors`` (shards of ``split``'s names, in
        its order) in one all-gather over ``group``."""
        n = comm.size(group)
        if n == 1 or not tensors:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        every = comm.all_gather(flat[None], group)
        out, at = [], 0
        for (dim, parts), t in zip(split.values(), tensors):
            k = t.numel()
            out.append(comm._join(every[:, at:at + k], t.shape, dim, n,
                                  parts))
            at += k
        return out

    # -- tp ----------------------------------------------------------------

    def shard_(self, model: nn.Module) -> nn.Module:
        """Replace each tp leaf of ``model`` by this rank's shard (a new
        Parameter)."""
        for name, owner in self._owners.items():
            attr = name.rpartition(".")[2]
            p = owner._parameters[attr]
            owner._parameters[attr] = nn.Parameter(
                self._tp_shard(name, p.detach()).clone(),
                requires_grad=p.requires_grad)
        return model

    @contextlib.contextmanager
    def materialized(self):
        """Within the block the model's tp leaves are the full weights,
        gathered from the shards (differentiably: the shards' gradients
        are this rank's slices).  Every rank of the ``model`` group must
        enter it.  Run the backward inside it too: a rematerialized
        forward reads the weights again there."""
        if not self.tp or self.model_size == 1:
            yield
            return
        attrs = [(n, o, n.rpartition(".")[2]) for n, o in self._owners.items()]
        shards = [o._parameters[a] for _, o, a in attrs]
        fulls = _GatherMany.apply(self, *shards)
        for (_, owner, attr), full in zip(attrs, fulls):
            owner._parameters[attr] = full
        try:
            yield
        finally:
            for (_, owner, attr), shard in zip(attrs, shards):
                owner._parameters[attr] = shard

    # -- gradients and the update -------------------------------------------

    def reduce_grads(self, grads: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Sum every gradient over ``data``: the ZeRO-1 ones
        reduce-scattered to this rank's shard, the rest all-reduced, each
        kind in one collective."""
        out = dict(grads)
        if self.data_size == 1:
            return out
        n, dg = self.data_size, self.data_group
        whole = [k for k in grads if k not in self.z1]
        if whole:
            flat = comm.all_reduce_(torch.cat(
                [grads[k].reshape(-1) for k in whole]), dg)
            at = 0
            for k in whole:
                size = grads[k].numel()
                out[k] = flat[at:at + size].view_as(grads[k])
                at += size
        split = [k for k in grads if k in self.z1]
        if split:
            by_rank = torch.cat([comm._by_rank(grads[k], *self._z1_args(k))
                                 .reshape(n, -1) for k in split], dim=1)
            mine = comm.reduce_scatter(by_rank, dg)[0]
            at = 0
            for k in split:
                shape = list(grads[k].shape)
                shape[self.z1[k][0]] //= n
                size = _size(shape)
                out[k] = mine[at:at + size].reshape(shape)
                at += size
        return out

    def _z1_args(self, name):
        dim, parts = self.z1[name]
        return dim, self.data_size, parts

    def grad_norms(self, grads: Mapping[str, torch.Tensor], trainable
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The global norms of all of ``grads`` and of the ``trainable``
        ones (reduced by :meth:`reduce_grads`): each tensor's squares
        summed over the groups that split it."""
        trainable = set(trainable)
        dev = next(iter(grads.values())).device
        total = torch.zeros(2, device=dev)
        sq = {}
        for k, g in grads.items():
            s = torch.sum(torch.square(g.float()))
            acc = sq.setdefault((k in self.tp, k in self.z1),
                                torch.zeros(2, device=dev))
            acc += torch.stack([s, s if k in trainable else 0.0 * s])
        for (in_tp, in_z1), v in sq.items():
            if in_z1:
                comm.all_reduce_(v, self.data_group)
            if in_tp:
                comm.all_reduce_(v, self.model_group)
            total += v
        norms = torch.sqrt(total)
        return norms[0], norms[1]

    def init_opt_state(self, opt, params: Mapping[str, torch.Tensor]):
        """``opt``'s state with the ZeRO-1 moments at their shards'
        shapes."""
        return opt.init({n: self._z1_shard(n, p.detach()) if n in self.z1
                         else p for n, p in params.items()})

    def update(self, opt, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], opt_state) -> torch.Tensor:
        """One optimizer update of ``params`` in place from this rank's
        ``grads``; returns the global norm of all gradients."""
        grads = self.reduce_grads(grads)
        trainable = opt.trainable(params)
        norms = self.grad_norms(grads, trainable)
        moved = [n for n in trainable if n in self.z1]
        local = dict(params)
        for n in moved:
            local[n] = self._z1_shard(n, params[n].detach()).clone()
        norm = opt.update(local, grads, opt_state, norms=norms)
        if moved:
            fulls = self._gather(self.data_group,
                                 {n: self.z1[n] for n in moved},
                                 [local[n] for n in moved])
            with torch.no_grad():
                for n, full in zip(moved, fulls):
                    params[n].copy_(full)
        return norm

    def reduce_metrics(self, values: torch.Tensor) -> torch.Tensor:
        """The global batch's losses: the sum of the ranks' parts (each a
        sum over its rows divided by the global count)."""
        return comm.all_reduce_(values.clone(), self.data_group)

    # -- checkpoints: the one-card layout -----------------------------------

    def _full(self, name, t):
        if name in self.z1:
            dim, parts = self.z1[name]
            t = comm.gather_dim(t.contiguous(), self.data_group, dim, parts)
        if name in self.tp:
            dim, parts = self.tp[name]
            t = comm.gather_dim(t.contiguous(), self.model_group, dim, parts)
        return t

    def full_params(self, params: Mapping[str, torch.Tensor]):
        """The one-card state dict (every rank must call it)."""
        return {n: comm.gather_dim(p.detach(), self.model_group,
                                   *self.tp[n]) if n in self.tp
                else p.detach() for n, p in params.items()}

    def full_opt_state(self, opt_state):
        """The one-card optimizer state (every rank must call it)."""
        out = dict(opt_state)
        for key in ("mu", "nu", "trace"):
            if key in out:
                out[key] = {n: self._full(n, t) for n, t in out[key].items()}
        return out

    def local_params(self, full: Mapping[str, torch.Tensor]):
        """This rank's parameters of a one-card state dict."""
        return {n: self._tp_shard(n, v).clone() if n in self.tp else v
                for n, v in full.items()}

    def local_opt_state(self, full):
        """This rank's part of a one-card optimizer state."""
        def cut(n, t):
            if n in self.tp:
                t = self._tp_shard(n, t)
            if n in self.z1:
                t = self._z1_shard(n, t)
            return t.clone()

        out = dict(full)
        for key in ("mu", "nu", "trace"):
            if key in out:
                out[key] = {n: cut(n, t) for n, t in out[key].items()}
        return out


def shard_params(model: nn.Module, mesh: Mesh, *, zero1: bool = False
                 ) -> ParallelLayout:
    """Keep this rank's shard of each tp leaf of ``model`` (in place);
    returns the layout the train step and the trainer use."""
    layout = ParallelLayout(model, mesh, zero1=zero1)
    layout.shard_(model)
    return layout


def shard_opt_state(opt_state, layout: ParallelLayout):
    """This rank's part of a one-card optimizer state."""
    return layout.local_opt_state(opt_state)
