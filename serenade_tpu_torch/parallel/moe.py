"""Expert parallelism: a Switch top-1 mixture-of-experts FFN over an
``expert`` rank axis (counterpart of serenade_tpu/parallel/moe.py).

Routing is dense one-hot dispatch and combine (``torch.einsum`` against
``(G, S, E, C)`` masks), with routing queues and the capacity
``ceil(group_size / E * capacity_factor)`` per group of tokens; tokens
past their expert's capacity bypass the experts through the residual.
The Switch auxiliary loss is over all tokens.

Under a mesh each rank holds its experts (:func:`place_moe_params`) and
its share of the groups (split over ``data`` then ``expert``): it routes
its groups, sends each expert's slots to the rank holding that expert and
takes the results back through ``comm.all_to_all`` (dispatch and
combine), and the groups are gathered so every rank returns the whole
output.  Routing is per group, so the result equals the one-rank run.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from serenade_tpu_torch.parallel import comm
from serenade_tpu_torch.parallel.mesh import Mesh, make_mesh


def init_moe_params(generator: torch.Generator, num_experts: int,
                    d_model: int, d_ff: int) -> Dict[str, torch.Tensor]:
    """Router ``(d, E)`` and E stacked expert FFNs ``wi`` ``(E, d, d_ff)``,
    ``wo`` ``(E, d_ff, d)`` (flax's ``(in, out)`` layout, as
    ``convert.stacked_from_flax`` carries JAX's), drawn from
    ``generator``."""
    def normal(*shape):
        return torch.randn(shape, generator=generator)

    s_in, s_ff = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {"router": normal(d_model, num_experts) * s_in,
            "wi": normal(num_experts, d_model, d_ff) * s_in,
            "wo": normal(num_experts, d_ff, d_model) * s_ff}


def moe_capacity(n_tokens: int, num_experts: int,
                 capacity_factor: float = 1.25) -> int:
    return max(int(math.ceil(n_tokens / num_experts * capacity_factor)), 1)


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
            capacity_factor: float = 1.25, group_size: Optional[int] = None,
            mesh: Optional[Mesh] = None, expert_axis: str = "expert",
            data_axis: Optional[str] = "data"):
    """Switch top-1 MoE FFN: x ``(B, T, D)`` -> (y, aux_loss).

    Tokens route in groups of ``group_size`` (default: one group a batch
    row).  ``mesh``: ``params`` hold this rank's experts
    (:func:`place_moe_params`) and the groups split over the mesh's
    ``data_axis`` and ``expert_axis`` ranks."""
    b, t, d = x.shape
    n = b * t
    s = group_size or t
    if n % s:
        raise ValueError(f"tokens {n} not divisible by group_size {s}")
    g = n // s
    e = params["router"].shape[1]
    cap = moe_capacity(s, e, capacity_factor)
    xg = x.reshape(g, s, d)
    egroup = dgroup = None
    if mesh is not None:
        egroup = mesh.group(expert_axis)
        dgroup = mesh.group(data_axis) if data_axis else None
        parts = comm.size(dgroup) * comm.size(egroup)
        if g % parts:
            raise ValueError(f"{g} groups do not split over {parts} ranks")
        mine = comm.rank(dgroup) * comm.size(egroup) + comm.rank(egroup)
        xg = comm.shard_of(xg, 0, parts, mine)

    logits = torch.einsum("gsd,de->gse", xg, params["router"])
    probs = torch.softmax(logits.float(), dim=-1)
    gate, choice = probs.max(dim=-1)                            # (G, S)
    onehot = torch.nn.functional.one_hot(choice, e).float()     # (G, S, E)
    # position of each token in its expert's queue of its group
    pos = torch.cumsum(onehot, dim=1) * onehot - 1.0
    keep = (pos >= 0) & (pos < cap)
    dispatch = keep[..., None] * torch.nn.functional.one_hot(
        pos.clamp(0, cap - 1).long(), cap).float()              # (G, S, E, C)
    combine = dispatch * gate[..., None, None]

    expert_in = torch.einsum("gsec,gsd->gecd", dispatch,
                             xg.float()).to(x.dtype)
    if egroup is not None:
        # dispatch: expert e's slots to the rank holding e
        gl = expert_in.shape[0]
        send = expert_in.transpose(0, 1).contiguous()          # (E, G, C, D)
        recv = comm.all_to_all(send, egroup)                    # (E, G, C, D)
        el = e // comm.size(egroup)
        # rows: for each peer p, this rank's el experts of p's groups
        h_in = recv.reshape(comm.size(egroup), el, gl, cap, d).transpose(
            0, 1).reshape(el, -1, cap, d)                       # (El, P*G, C, D)
        h = torch.nn.functional.gelu(
            torch.einsum("egcd,edf->egcf", h_in, params["wi"]))
        out = torch.einsum("egcf,efd->egcd", h, params["wo"])
        back = out.reshape(el, comm.size(egroup), gl, cap, d).transpose(
            0, 1).reshape(e, gl, cap, d)
        # combine: the results back to the ranks whose tokens they are
        expert_out = comm.all_to_all(back.contiguous(), egroup).transpose(
            0, 1)                                               # (G, E, C, D)
    else:
        h = torch.nn.functional.gelu(
            torch.einsum("gecd,edf->gecf", expert_in, params["wi"]))
        expert_out = torch.einsum("gecf,efd->gecd", h, params["wo"])

    y = torch.einsum("gsec,gecd->gsd", combine, expert_out.float())
    # overflow tokens (an all-zero combine row) pass through unchanged
    y = y + xg.float()

    # Switch load balance, E * sum_e f_e * p_e, over all tokens
    stats = torch.stack([onehot.sum(dim=(0, 1)), probs.sum(dim=(0, 1))])
    stats = comm.reduce_from_group(comm.reduce_from_group(stats, egroup),
                                   dgroup)
    stats = stats / float(n)
    aux = e * torch.sum(stats[0] * stats[1])
    y = comm.gather_from_group(comm.gather_from_group(y, egroup), dgroup)
    return y.reshape(b, t, d).to(x.dtype), aux


def place_moe_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                     expert_axis: str = "expert") -> Dict[str, torch.Tensor]:
    """This rank's experts (the leading expert axis split over
    ``expert_axis``) and the whole router: each rank holds only its
    experts, the memory point of ep."""
    n, i = mesh.axis_size(expert_axis), mesh.axis_index(expert_axis)
    return {k: v.clone() if k == "router" else
            comm.shard_of(v, 0, n, i).clone() for k, v in params.items()}


def expert_mesh(expert: int, data: int = 1) -> Mesh:
    """A ``('data', 'expert')`` rank mesh."""
    return make_mesh(data=data, model=expert, axis_names=("data", "expert"))
