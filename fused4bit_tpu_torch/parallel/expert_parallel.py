"""Expert-parallel MoE and tensor-parallel linear execution over a mesh.

Counterpart of ``fused4bit_tpu/parallel/expert_parallel.py``. Each rank
holds its shard: stacked expert weights [E / D, N, K]
(:func:`~.sharding.shard_qt_experts`), a linear's rows [N / D, K]
(:func:`~.sharding.shard_qt_out_dim`), and, for the data-sharded
strategies, its own tokens. Four EP strategies, as in JAX:

* :func:`moe_ep_replicated`: tokens replicated over the expert axis; each
  rank runs the grouped INT4 kernel (K2, or K13/K12 per group) for its
  experts only and the partials are summed over the axis in rank order.
  Dropless, no all_to_all; for decode (few tokens, weight-streaming bound)
  the 1/D weight slice per rank is the bandwidth split that matters.
* :func:`moe_ep_a2a`: tokens data-sharded; per-destination capacity buffers
  exchanged with ``all_to_all_single``, the local grouped product, and back.
  Pairs beyond capacity drop (Switch/GShard semantics), exactly as in JAX.
* :func:`moe_ep_a2a_dropless`: ``all_to_all_single`` with split sizes is the
  ragged exchange itself: only real rows move, nothing drops.
* :func:`moe_ep_ring`: D ring hops (isend/irecv), each rank adding its
  experts' contribution to every visiting token block; dropless.

:func:`tp_int4_matmul` runs K1 (K7/K6 for per-group weights) on the rank's
N-shard and gathers the output along its last dim.

Each strategy's compute is a per-rank body, a function of ``(rank, world,
local tensors)`` (:func:`moe_ep_replicated_body`, the a2a strategies'
:func:`expert_rows`; :func:`tp_int4_matmul_body` needs only the rank's
shard), beside the collectives that join
them, so that the bodies of a D-way split can run one after another on one
card and meet in the same summation code (:func:`~.mesh.sum_in_rank_order`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..layers.moe import RoutingResult, combine, dispatch, make_dispatch_plan, topk_route
from ..ops.grouped_matmul import grouped_int4_matmul, grouped_int4_matmul_per_group
from ..ops.int4_matmul import int4_matmul, int4_matmul_per_group
from ..quant.core import QuantizedTensor
from .mesh import (
    all_gather_dim, all_gather_ordered, all_to_all, axis_index, axis_size, psum, ring_shift,
)

__all__ = [
    "moe_ep_replicated", "moe_ep_a2a", "moe_ep_a2a_dropless", "moe_ep_ring",
    "tp_int4_matmul", "moe_ep_replicated_body", "tp_int4_matmul_body", "expert_rows",
    "local_routing",
]


def _grouped_local(xs: torch.Tensor, gids: torch.Tensor, qt_loc: QuantizedTensor,
                   tile_m: int) -> torch.Tensor:
    """The local grouped product, by granularity: per_row on K2; per_group
    on K13 (planar_groups) or K12 (planar)."""
    if qt_loc.granularity == "per_group":
        return grouped_int4_matmul_per_group(xs, gids, qt_loc, tile_m=tile_m)
    return grouped_int4_matmul(xs, gids, qt_loc, tile_m=tile_m)


def _experts(router_logits: torch.Tensor, qt_loc: QuantizedTensor, world: int):
    """(global E, local E); raises unless the logits name world x local
    experts."""
    e_local = qt_loc.shape[0]
    e = router_logits.shape[-1]
    if e != e_local * world:
        raise ValueError(f"num_experts={e} is not {world} ranks x {e_local} local experts")
    return e, e_local


def _offsets(tpe: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(tpe.shape[0] + 1, dtype=torch.int32, device=tpe.device)
    out[1:] = torch.cumsum(tpe, 0)
    return out


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """bincount of ``ids`` over ``n`` bins, int32, with no host sync."""
    ids = ids.reshape(-1).long()
    return torch.zeros(n, dtype=torch.int32, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids, dtype=torch.int32))


def local_routing(expert_indices: torch.Tensor, expert_weights: torch.Tensor, lo: int,
                  e_local: int) -> RoutingResult:
    """The global routing seen by the rank holding experts [lo, lo + e_local):
    foreign pairs go to local expert 0 with weight 0, so their rows flow
    through the kernel and add nothing after weighting."""
    local_ids = expert_indices - lo
    mine = (local_ids >= 0) & (local_ids < e_local)
    local_ids = torch.where(mine, local_ids, 0).to(torch.int32)
    weights = torch.where(mine, expert_weights, 0.0)
    tpe = _counts(local_ids, e_local)
    return RoutingResult(local_ids, weights, tpe, _offsets(tpe))


def _local_contrib(xblk, eids, weights, lo, e_local, qt_loc, tile_m) -> torch.Tensor:
    """One rank's dropless contribution [T, N] for a token block."""
    rt = local_routing(eids, weights, lo, e_local)
    plan = make_dispatch_plan(rt, e_local, tile_m=tile_m)
    y = _grouped_local(dispatch(xblk, rt, plan), plan.tile_group_ids, qt_loc, tile_m)
    return combine(y, rt, plan)


# ---------------------------------------------------------------------------
# EP strategy 1: replicated tokens, sharded experts, fixed-order sum
# ---------------------------------------------------------------------------


def moe_ep_replicated_body(rank: int, world: int, x: torch.Tensor, router_logits: torch.Tensor,
                           qt_loc: QuantizedTensor, *, top_k: int,
                           tile_m: int = 16) -> torch.Tensor:
    """Rank ``rank``'s partial [T, N] of :func:`moe_ep_replicated`: the
    contributions of its experts [rank * E_local, (rank + 1) * E_local)."""
    e, e_local = _experts(router_logits, qt_loc, world)
    routing = topk_route(router_logits, top_k, e)
    return _local_contrib(x, routing.expert_indices, routing.expert_weights, rank * e_local,
                          e_local, qt_loc, tile_m)


def moe_ep_replicated(
    x: torch.Tensor,              # [T, H], the same on every rank of the axis
    router_logits: torch.Tensor,  # [T, E], the same on every rank of the axis
    qt: QuantizedTensor,          # this rank's experts [E / D, N, K]
    mesh: DeviceMesh,
    *,
    top_k: int,
    axis: str = "expert",
    tile_m: int = 16,
) -> torch.Tensor:
    """Dropless EP MoE: every rank keeps all tokens, computes only its
    experts' contributions, and the partials are summed in rank order.
    Returns [T, N], the same bits on every rank."""
    part = moe_ep_replicated_body(axis_index(mesh, axis), axis_size(mesh, axis), x,
                                  router_logits, qt, top_k=top_k, tile_m=tile_m)
    return psum(part, mesh, axis)


# ---------------------------------------------------------------------------
# EP strategy 2: data-sharded tokens, all_to_all exchange, capacity buffers
# ---------------------------------------------------------------------------


def expert_rows(recv_x: torch.Tensor, recv_eid: torch.Tensor, qt_loc: QuantizedTensor,
                tile_m: int) -> torch.Tensor:
    """Rows received by a rank through its experts, in received order:
    ``recv_x`` [R, H] with local expert ids ``recv_eid`` [R] (-1: an empty
    slot, which comes back as a zero row). The a2a strategies' per-rank
    body: a synthetic top-1 routing of the rows, the grouped product, and
    the rows put back in order."""
    e_local = qt_loc.shape[0]
    valid = recv_eid >= 0
    eid = torch.where(valid, recv_eid, 0).to(torch.int32)
    tpe = _counts(eid, e_local)
    rt = RoutingResult(eid[:, None], torch.ones((eid.shape[0], 1), dtype=torch.float32,
                                                  device=eid.device), tpe, _offsets(tpe))
    plan = make_dispatch_plan(rt, e_local, tile_m=tile_m)
    xs = dispatch(torch.where(valid[:, None], recv_x, 0.0), rt, plan)
    y = _grouped_local(xs, plan.tile_group_ids, qt_loc, tile_m)
    return torch.where(valid[:, None], y[plan.rows], 0.0)


def moe_ep_a2a(
    x: torch.Tensor,              # [T_loc, H], this rank's tokens
    router_logits: torch.Tensor,  # [T_loc, E]
    qt: QuantizedTensor,          # this rank's experts [E / D, N, K]
    mesh: DeviceMesh,
    *,
    top_k: int,
    axis: str = "expert",
    capacity_factor: float = 2.0,
    tile_m: int = 16,
) -> torch.Tensor:
    """Capacity-factor EP MoE with all_to_all token exchange.

    Per rank: route the local tokens, pack a [D, C, H] send buffer (C = the
    per-destination capacity, JAX's expression, tile-aligned), exchange,
    run the local experts, exchange back, weighted combine. A pair past its
    destination's capacity drops (its row adds 0). Returns [T_loc, N]."""
    n_dev = axis_size(mesh, axis)
    e, e_local = _experts(router_logits, qt, n_dev)
    t_loc, h = x.shape
    cap = max(int(capacity_factor * t_loc * top_k / n_dev), tile_m)
    cap = -(-cap // tile_m) * tile_m

    routing = topk_route(router_logits, top_k, e)
    flat_ids = routing.expert_indices.reshape(-1).long()                 # [T*k]
    dest = flat_ids // e_local
    # slot of each pair within its destination buffer: its rank among the
    # pairs with the same destination, in flat order
    onehot = F.one_hot(dest, n_dev)
    slot = (torch.cumsum(onehot, 0) - onehot).gather(1, dest[:, None])[:, 0]
    keep = slot < cap
    # dropped pairs write one extra row, cut off before the exchange
    row = torch.where(keep, dest * cap + slot, n_dev * cap)
    send_x = x.new_zeros((n_dev * cap + 1, h)).index_copy_(
        0, row, x.repeat_interleave(top_k, dim=0))[:-1]
    send_eid = torch.full((n_dev * cap + 1,), -1, dtype=torch.int32, device=x.device).index_copy_(
        0, row, (flat_ids % e_local).to(torch.int32))[:-1]

    recv_x = all_to_all(send_x, mesh, axis)
    recv_eid = all_to_all(send_eid, mesh, axis)
    y_rows = expert_rows(recv_x, recv_eid, qt, tile_m)
    y_recv = all_to_all(y_rows, mesh, axis).reshape(n_dev, cap, -1)
    per_pair = y_recv[dest, slot.clamp(max=cap - 1)]
    per_pair = torch.where(keep[:, None], per_pair, 0.0).reshape(t_loc, top_k, -1)
    w = routing.expert_weights.to(per_pair.dtype)[..., None]
    return (per_pair * w).sum(dim=1)


# ---------------------------------------------------------------------------
# EP strategy 3: dropless all_to_all with split sizes
# ---------------------------------------------------------------------------


def moe_ep_a2a_dropless(
    x: torch.Tensor,              # [T_loc, H], this rank's tokens
    router_logits: torch.Tensor,  # [T_loc, E]
    qt: QuantizedTensor,          # this rank's experts [E / D, N, K]
    mesh: DeviceMesh,
    *,
    top_k: int,
    axis: str = "expert",
    recv_rows: Optional[int] = None,
    tile_m: int = 16,
) -> torch.Tensor:
    """Dropless EP MoE: sort the pairs by destination, exchange exactly the
    real rows, run the local experts, send the results straight back.

    Per rank: (1) route, stable-sort the (token, k) pairs by destination
    rank (expert // E_local); (2) all-gather the [D] per-destination counts
    (D x D int32); (3) ``all_to_all_single`` the rows and their local expert
    ids with those split sizes; (4) the local grouped product
    (:func:`expert_rows`); (5) ``all_to_all_single`` the results back with
    the sizes swapped, un-sort, weighted combine.

    The split sizes reach the host once per call: ``all_to_all_single``
    takes them as Python ints, so the gathered counts are read with one
    ``.tolist()``, a device-to-host sync, per call (per MoE block). JAX
    avoids it with a static receive buffer of ``recv_rows`` rows that its
    ragged collective fills; here the receive buffer holds exactly the rows
    that arrive, and ``recv_rows`` is only the bound JAX's buffer sets: when
    more rows are routed to one rank, every rank raises ``ValueError``,
    where JAX would corrupt the exchange. Returns [T_loc, N].
    """
    n_dev = axis_size(mesh, axis)
    me = axis_index(mesh, axis)
    e, e_local = _experts(router_logits, qt, n_dev)
    t_loc = x.shape[0]
    routing = topk_route(router_logits, top_k, e)
    flat_ids = routing.expert_indices.reshape(-1).long()
    dest = flat_ids // e_local
    sort_idx = torch.argsort(dest, stable=True)
    x_send = x.repeat_interleave(top_k, dim=0)[sort_idx]
    eid_send = (flat_ids % e_local).to(torch.int32)[sort_idx]

    counts_all = torch.stack(all_gather_ordered(_counts(dest, n_dev), mesh, axis))  # [from, to]
    counts_all = counts_all.tolist()                     # the call's one host sync
    send_sizes = counts_all[me]
    recv_sizes = [counts_all[j][me] for j in range(n_dev)]
    most = max(sum(col) for col in zip(*counts_all))
    if recv_rows is not None and most > recv_rows:   # every rank sees it and raises
        raise ValueError(f"{most} rows routed to one rank, above recv_rows={recv_rows}")
    recv_x = all_to_all(x_send, mesh, axis, recv_sizes, send_sizes)
    recv_eid = all_to_all(eid_send, mesh, axis, recv_sizes, send_sizes)
    y_rows = expert_rows(recv_x, recv_eid, qt, tile_m)
    y_back = all_to_all(y_rows, mesh, axis, send_sizes, recv_sizes)   # sorted pair order
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(sort_idx.shape[0], device=sort_idx.device)
    per_pair = y_back[inv].reshape(t_loc, top_k, -1)
    w = routing.expert_weights.to(per_pair.dtype)[..., None]
    return (per_pair * w).sum(dim=1)


# ---------------------------------------------------------------------------
# EP strategy 4: ring rotation
# ---------------------------------------------------------------------------


def moe_ep_ring(
    x: torch.Tensor,              # [T_loc, H], this rank's tokens
    router_logits: torch.Tensor,  # [T_loc, E]
    qt: QuantizedTensor,          # this rank's experts [E / D, N, K]
    mesh: DeviceMesh,
    *,
    top_k: int,
    axis: str = "expert",
    tile_m: int = 16,
) -> torch.Tensor:
    """Dropless EP MoE over D ring hops: each token block visits every
    rank, which adds its experts' contributions to the block's f32
    accumulator, and arrives home after D hops with the full top-k sum.
    Every hop sends the block, its routing and its accumulator to the next
    rank (isend/irecv). Returns [T_loc, N]."""
    n_dev = axis_size(mesh, axis)
    e, e_local = _experts(router_logits, qt, n_dev)
    lo = axis_index(mesh, axis) * e_local
    routing = topk_route(router_logits, top_k, e)
    xblk, eids, wblk = x, routing.expert_indices, routing.expert_weights
    yblk = torch.zeros((x.shape[0], qt.out_dim), dtype=torch.float32, device=x.device)
    for _ in range(n_dev):
        c = _local_contrib(xblk, eids, wblk, lo, e_local, qt, tile_m)
        xblk, eids, wblk, yblk = ring_shift([xblk, eids, wblk, yblk + c.float()], mesh, axis)
    return yblk.to(x.dtype)


# ---------------------------------------------------------------------------
# Tensor parallelism for the fused linear kernel
# ---------------------------------------------------------------------------


def tp_int4_matmul_body(x: torch.Tensor, qt_loc: QuantizedTensor) -> torch.Tensor:
    """A rank's columns [..., N / D] of :func:`tp_int4_matmul`: its
    N-shard's product, by granularity: per_row on K1; per_group on K7
    (planar_groups) or K6 (planar)."""
    if qt_loc.granularity == "per_group":
        return int4_matmul_per_group(x, qt_loc)
    return int4_matmul(x, qt_loc)


def tp_int4_matmul(
    x: torch.Tensor,          # [..., K], the same on every rank of the axis
    qt: QuantizedTensor,      # this rank's rows [N / D, K]
    mesh: DeviceMesh,
    *,
    axis: str = "model",
    gather_output: bool = True,
) -> torch.Tensor:
    """Column-parallel INT4 linear: each rank computes its N-shard with the
    kernel; with ``gather_output`` the shards are gathered in rank order
    along the last dim to [..., N], else the rank's [..., N / D] returns."""
    y = tp_int4_matmul_body(x, qt)
    return all_gather_dim(y, mesh, axis, y.dim() - 1) if gather_output else y
