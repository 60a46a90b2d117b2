"""Mixture-of-Experts routing, dispatch/combine, and the INT4 expert module.

Counterpart of ``fused4bit_tpu/layers/moe.py``: top-k softmax routing with
renormalized weights, and two dispatch plans:

* dropless (``make_dispatch_plan``): every expert's group is padded to a
  ``tile_m`` boundary inside a buffer of static size
  ``cdiv(T*k, tile_m)*tile_m + E*tile_m``;
* capacity (``make_capacity_plan``): every expert owns a fixed segment of
  ``capacity`` rows; pairs past it are dropped (Switch semantics), marked by
  the out-of-range row ``t_pad``, which ``dispatch`` discards and ``combine``
  reads as zero.

Everything runs as tensor ops on the device with no device-to-host sync, so
the grouped kernels see one launch per projection. Also here, as in JAX:
``simulate_router_logits`` (the reference library's three benchmark routing
laws) and ``QuantizedMoE`` (dequantize, then a matmul per expert: the golden
baseline module).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .._device import resolve_device
from ..ops.grouped_matmul import (
    grouped_int4_matmul,
    grouped_int4_matmul_a8,
    grouped_int4_matmul_per_group,
    grouped_int4_matmul_per_group_a8,
    grouped_int4_matmul_per_group_reference,
    grouped_int4_matmul_reference,
)
from ..ops.int8_xla import Int8Resident
from ..quant.core import QuantizedTensor, dequantize, quantize
from ..quant.reference import full_precision
from .linear import per_group_layout, pg_kernel_format

__all__ = [
    "RoutingResult",
    "DispatchPlan",
    "topk_route",
    "simulate_router_logits",
    "make_dispatch_plan",
    "make_capacity_plan",
    "expert_load_stats",
    "dispatch",
    "combine",
    "MoEINT4",
    "QuantizedMoE",
]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class RoutingResult:
    expert_indices: torch.Tensor        # [T, k] i32
    expert_weights: torch.Tensor        # [T, k] f32, renormalized over k
    tokens_per_expert: torch.Tensor     # [E] i32
    expert_token_offsets: torch.Tensor  # [E+1] i32 (unpadded, cumulative)


def topk_route(logits: torch.Tensor, top_k: int, num_experts: int) -> RoutingResult:
    """Softmax-of-logits top-k routing with renormalized weights."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, indices = torch.topk(probs, top_k, dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    flat = indices.reshape(-1)
    # scatter_add, not bincount: bincount reads the max back to the host
    tokens_per_expert = torch.zeros(num_experts, dtype=torch.int32, device=logits.device)
    tokens_per_expert.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    offsets = torch.zeros(num_experts + 1, dtype=torch.int32, device=logits.device)
    offsets[1:] = torch.cumsum(tokens_per_expert, 0)
    return RoutingResult(indices.to(torch.int32), weights, tokens_per_expert, offsets)


def simulate_router_logits(generator: torch.Generator, num_tokens: int, num_experts: int,
                           distribution: str = "uniform") -> torch.Tensor:
    """Benchmark router logits [T, E] on the generator's device, by the
    reference library's laws: "uniform" (N(0, 0.01^2)), "skewed" (zipf:
    log(1/(i+1)) for expert i plus N(0, 1)) or "random" (N(0, 100)). The
    laws are JAX's; the draws, from ``generator``, are not ``jax.random``'s."""
    def normal() -> torch.Tensor:
        return torch.randn((num_tokens, num_experts), generator=generator,
                           device=generator.device)

    if distribution == "uniform":
        return normal() * 0.01
    if distribution == "skewed":
        ranks = torch.arange(num_experts, dtype=torch.float32, device=generator.device)
        return torch.log(1.0 / (ranks + 1.0))[None, :] + normal()
    if distribution == "random":
        return normal() * 10.0
    raise ValueError(f"unknown distribution {distribution!r}")


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """Static-shape routing plan feeding the grouped kernel.

    rows:            [T*k] i64 - destination row in the padded buffer of each
                     (token, k) pair, in flat token-major order.
    tile_group_ids:  [num_tiles] i32 - expert of each m-tile.
    t_pad:           padded buffer length.
    tile_m:          m-tile size.
    drops:           whether rows may hold t_pad (a dropped pair): set by
                     make_capacity_plan, so dropless plans keep the plain
                     scatter and gather.
    """

    rows: torch.Tensor
    tile_group_ids: torch.Tensor
    t_pad: int
    tile_m: int
    drops: bool = False


def make_dispatch_plan(routing: RoutingResult, num_experts: int, tile_m: int = 64) -> DispatchPlan:
    """Destination rows and the tile->expert map for sorted dispatch."""
    flat_ids = routing.expert_indices.reshape(-1).long()
    tk = flat_ids.shape[0]
    device = flat_ids.device
    t_pad = _cdiv(tk, tile_m) * tile_m + num_experts * tile_m
    num_tiles = t_pad // tile_m

    padded_sizes = (routing.tokens_per_expert.long() + tile_m - 1) // tile_m * tile_m
    padded_offsets = torch.zeros(num_experts + 1, dtype=torch.long, device=device)
    padded_offsets[1:] = torch.cumsum(padded_sizes, 0)

    # Rank of each (token, k) pair within its expert, in flat order: stable
    # argsort by expert id, then invert.
    sort_idx = torch.argsort(flat_ids, stable=True)
    ranks_sorted = (torch.arange(tk, device=device)
                    - routing.expert_token_offsets.long()[flat_ids[sort_idx]])
    ranks = torch.empty_like(ranks_sorted)
    ranks[sort_idx] = ranks_sorted
    rows = padded_offsets[flat_ids] + ranks

    # Tile t belongs to expert e iff padded_offsets[e] <= t*tile_m <
    # padded_offsets[e+1]; tiles past the last group map to expert E-1 and
    # carry only zero rows.
    tile_starts = torch.arange(num_tiles, device=device) * tile_m
    tile_group_ids = torch.searchsorted(
        padded_offsets[1:].contiguous(), tile_starts, right=True
    ).clamp(0, num_experts - 1).to(torch.int32)
    return DispatchPlan(rows, tile_group_ids, t_pad, tile_m)


def make_capacity_plan(routing: RoutingResult, num_experts: int, capacity: int,
                       tile_m: int = 16) -> DispatchPlan:
    """Capacity plan: expert e owns rows [e*capacity, (e+1)*capacity) of a
    buffer of E*capacity rows; a pair past its expert's capacity gets row
    t_pad and is dropped. The layout reshapes to [E, capacity, H]."""
    if capacity % tile_m != 0:
        raise ValueError(f"capacity={capacity} must be a multiple of tile_m={tile_m}")
    flat_ids = routing.expert_indices.reshape(-1).long()
    device = flat_ids.device
    sort_idx = torch.argsort(flat_ids, stable=True)
    ranks_sorted = (torch.arange(flat_ids.shape[0], device=device)
                    - routing.expert_token_offsets.long()[flat_ids[sort_idx]])
    ranks = torch.empty_like(ranks_sorted)
    ranks[sort_idx] = ranks_sorted
    t_pad = num_experts * capacity
    rows = torch.where(ranks < capacity, flat_ids * capacity + ranks,
                       torch.full_like(ranks, t_pad))
    tile_group_ids = torch.arange(num_experts, dtype=torch.int32, device=device
                                  ).repeat_interleave(capacity // tile_m)
    return DispatchPlan(rows, tile_group_ids, t_pad, tile_m, drops=True)


def expert_load_stats(routing: RoutingResult, capacity: int = 0) -> dict:
    """Per-expert load fraction [E], max-over-mean imbalance, and (capacity
    > 0) the number of pairs past capacity, as device tensors."""
    tpe = routing.tokens_per_expert.float()
    load = tpe / tpe.sum().clamp(min=1.0)
    imbalance = tpe.max() / tpe.mean().clamp(min=1e-9)
    if capacity > 0:
        dropped = (routing.tokens_per_expert - capacity).clamp(min=0).sum().to(torch.int32)
    else:
        dropped = torch.zeros((), dtype=torch.int32, device=tpe.device)
    return dict(load_fraction=load, imbalance=imbalance, dropped=dropped)


def dispatch(x: torch.Tensor, routing: RoutingResult, plan: DispatchPlan) -> torch.Tensor:
    """Scatter tokens into the sorted, tile-aligned buffer [T_pad, H]; each
    token appears once per selected expert. Dropped pairs (row t_pad) land in
    one extra row that is cut off."""
    k = routing.expert_indices.shape[1]
    x_rep = x.repeat_interleave(k, dim=0)   # token-major [T*k, H]
    rows = plan.t_pad + 1 if plan.drops else plan.t_pad
    buf = torch.zeros((rows, x.shape[1]), dtype=x.dtype, device=x.device)
    return buf.index_copy_(0, plan.rows, x_rep)[: plan.t_pad]


def combine(expert_out: torch.Tensor, routing: RoutingResult, plan: DispatchPlan) -> torch.Tensor:
    """Gather back to token order and weight-sum over the top-k. Dropped
    pairs (row t_pad) read a zero row."""
    t, k = routing.expert_weights.shape
    if plan.drops:
        expert_out = torch.cat([expert_out, expert_out.new_zeros((1, expert_out.shape[1]))])
    per_pair = expert_out.index_select(0, plan.rows).reshape(t, k, -1)
    w = routing.expert_weights.to(per_pair.dtype)[..., None]
    return (per_pair * w).sum(dim=1)


class MoEINT4(nn.Module):
    """Stacked per-expert INT4 weights [E, N, K] applied by a grouped kernel
    to pre-routed, tile-packed inputs: per_row planar weights on K2 (or K9
    with ``mode="ksplit"``) with ``activation="bf16"`` and K10 with
    ``"int8"``; per_group planar_groups weights on K13 and K14; per_group
    planar weights (what ``models.convert`` produces) on K12 in both
    activations, as in JAX. Every other format (per_tensor, the interleaved
    and block_planar layouts, group sizes no kernel takes), and every weight
    with ``use_kernel=False``, runs the golden path, as in JAX: dequantize,
    then a float32 matmul per expert, through the counted plain versions
    ``ops.grouped_int4_matmul_reference`` (per-group:
    ``ops.grouped_int4_matmul_per_group_reference``). ``w8``: the
    i8-resident copy the xla_turbo capacity path runs on.

    A module placed on a mesh (``parallel.place_model``) holds E_local of
    the stack's experts: ``shape`` stays the whole stack's, as the JAX
    package's static metadata does, and :attr:`weight` is the view of the
    experts it holds."""

    def __init__(self, weight: QuantizedTensor, *, activation: str = "bf16",
                 use_kernel: bool = True, w8: Optional[Int8Resident] = None):
        super().__init__()
        if activation not in ("bf16", "int8"):
            raise ValueError(f"activation={activation!r} is not 'bf16' or 'int8'")
        self.register_buffer("packed", weight.packed)
        self.register_buffer("scales", weight.scales)
        self.register_buffer("zero_points", weight.zero_points)
        self.register_buffer("w8_q8", None if w8 is None else w8.q8)
        self.register_buffer("w8_scales", None if w8 is None else w8.scales)
        self.shape = tuple(weight.shape)
        self.bits = weight.bits
        self.granularity = weight.granularity
        self.layout = weight.layout
        self.block_k = weight.block_k
        self.group_size = weight.group_size
        self.activation = activation
        self.use_kernel = use_kernel

    @classmethod
    def from_dense(cls, weights: torch.Tensor, *, granularity: str = "per_row",
                   group_size: int = 128, device=None, **kw) -> "MoEINT4":
        """Quantize stacked dense expert weights [E, N, K], per_row or
        per_group (planar_groups where the batched-partials kernels take it).
        The module lives on the weights' device, or on ``device`` when one is
        given."""
        if device is not None:
            weights = weights.to(resolve_device(device))
        layout = per_group_layout(weights.shape[-1], granularity, group_size)
        return cls(quantize(weights, granularity=granularity, layout=layout,
                            group_size=group_size), **kw)

    @property
    def weight(self) -> QuantizedTensor:
        shape = (self.packed.shape[0],) + tuple(self.shape[1:])
        return QuantizedTensor(self.packed, self.scales, self.zero_points, shape,
                               granularity=self.granularity, layout=self.layout,
                               block_k=self.block_k, group_size=self.group_size,
                               bits=self.bits)

    @property
    def w8(self) -> Optional[Int8Resident]:
        return None if self.w8_q8 is None else Int8Resident(self.w8_q8, self.w8_scales)

    @property
    def num_experts(self) -> int:
        return self.shape[0]

    def forward(self, x_sorted: torch.Tensor, tile_group_ids: torch.Tensor,
                *, tile_m: int = 64, **kw) -> torch.Tensor:
        """The grouped product; ``kw`` (for example ``mode=`` of
        ``grouped_int4_matmul``) goes on to the grouped op, as in JAX."""
        w = self.weight
        if self.use_kernel and w.granularity == "per_row" and w.layout == "planar":
            if self.activation == "int8":
                return grouped_int4_matmul_a8(x_sorted, tile_group_ids, w, tile_m=tile_m, **kw)
            return grouped_int4_matmul(x_sorted, tile_group_ids, w, tile_m=tile_m, **kw)
        if (self.use_kernel and self.activation == "int8" and w.granularity == "per_group"
                and w.layout == "planar_groups"):
            return grouped_int4_matmul_per_group_a8(x_sorted, tile_group_ids, w, tile_m=tile_m,
                                                    **kw)
        if self.use_kernel and pg_kernel_format(w):
            # K13 (planar_groups) or K12 (planar)
            return grouped_int4_matmul_per_group(x_sorted, tile_group_ids, w, tile_m=tile_m, **kw)
        # no kernel, as in JAX: the golden dequantize-and-matmul per expert
        golden = (grouped_int4_matmul_per_group_reference if w.granularity == "per_group"
                  else grouped_int4_matmul_reference)
        return golden(x_sorted, tile_group_ids, w, tile_m=tile_m)


class QuantizedMoE(nn.Module):
    """Dequantize-then-matmul per-expert MoE over stacked INT4 weights
    [E, N, K] (the reference library's golden baseline module): every token
    through its top-k experts' dequantized weights in float32, weighted by
    the router's renormalized scores."""

    def __init__(self, weight: QuantizedTensor):
        super().__init__()
        self.register_buffer("packed", weight.packed)
        self.register_buffer("scales", weight.scales)
        self.register_buffer("zero_points", weight.zero_points)
        self.meta = {f.name: getattr(weight, f.name) for f in dataclasses.fields(weight)
                     if f.name not in ("packed", "scales", "zero_points")}

    @classmethod
    def from_dense(cls, weights: torch.Tensor, **kw) -> "QuantizedMoE":
        """Quantize stacked dense weights [E, N, K], planar (``kw``: the
        granularity and group size)."""
        return cls(quantize(weights, layout="planar", **kw))

    @property
    def weight(self) -> QuantizedTensor:
        return QuantizedTensor(self.packed, self.scales, self.zero_points, **self.meta)

    def forward(self, x: torch.Tensor, routing: RoutingResult) -> torch.Tensor:
        """Token-order input [T, K] -> combined output [T, N]."""
        w = dequantize(self.weight, dtype=torch.float32)          # [E, N, K]
        we = w[routing.expert_indices.long()]                      # [T, k, N, K]
        with full_precision():
            y = torch.einsum("tk,tenk->ten", x.float(), we)
        return (y * routing.expert_weights[..., None]).sum(dim=1).to(x.dtype)

    def total_memory_bytes(self) -> int:
        """The packed weights', scales' and zero points' bytes."""
        return self.weight.nbytes
