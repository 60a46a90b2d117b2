"""Whole-model sharded decode: DP batch x EP experts.

Counterpart of ``fused4bit_tpu/parallel/sharded_model.py``: attention,
norms, the embedding, the routers and the lm_head are replicated; each MoE
block's stacked expert weights are split over the mesh `expert` axis; the
batch (tokens, positions, KV caches) is split over `data`. :func:`place_model`
turns every ``MoEBlock`` into an :class:`EPMoEBlock`, which runs the block's
own forward on the rank's experts and sums the partials over `expert` in
rank order (``expert_parallel.moe_ep_replicated``'s rationale: at decode the
1/D split of the weight streaming is the win). :func:`sharded_decode_step`
is the placed model's own forward on the rank's batch shard, with the
logits gathered over `data`, so every rank returns the whole batch's.

This is the multi-card serving configuration of the JAX package:
Mixtral-geometry INT4 decode with the experts split across the cards.
"""
from __future__ import annotations

import copy
import itertools
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.transformer import MoEBlock, QuantizedTransformer
from .mesh import all_gather_dim, axis_index, axis_size, psum
from .sharding import Shard, shard_tensor

__all__ = ["EPMoEBlock", "model_pspecs", "place_model", "sharded_decode_step"]

_EXPERT_FIELDS = ("w_gate", "w_up", "w_down")


def model_pspecs(model: QuantizedTransformer,
                 expert_axis: str = "expert") -> Dict[str, Optional[Shard]]:
    """The rule for every tensor of the model, by ``state_dict`` name: the
    expert stacks' tensors (packed, scales, zero points, and the resident i8
    copy where there is one) split their E dim over ``expert_axis``; the
    rest is replicated (None)."""
    moe = [f"blocks.{i}.moe." for i, blk in enumerate(model.blocks)
           if isinstance(blk.moe, MoEBlock)]
    return {name: Shard(expert_axis, 0)
            if any(name.startswith(pre + f + ".") for pre in moe for f in _EXPERT_FIELDS)
            else None
            for name in model.state_dict()}


class EPMoEBlock(MoEBlock):
    """A ``MoEBlock`` holding this rank's experts [lo, lo + E_local) of the
    block's E, its output summed over ``axis`` in rank order.

    The router is replicated and routes over the global experts, and every
    path of ``MoEBlock.forward`` runs on the local experts, as a block that
    holds a share of them does: the dropless grouped path
    sees the local filter (``layers.moe.local_routing``: foreign pairs are
    dropped); the capacity paths (``moe_impl`` u4_turbo and xla_turbo,
    ``prefill_impl="einsum"``) take the whole block's capacity plan cut to
    the rank's segment, so a pair is kept or dropped as on one card. A
    shared expert, replicated, is added after the sum. At one rank along ``axis`` this is the block's own forward, bit for
    bit. Its checkpoint description is the
    whole block's (``num_experts`` stays global, the EP state is private), so
    a checkpoint moves between placed and whole models."""

    checkpoint_class = "MoEBlock"

    def __init__(self, block: MoEBlock, mesh: DeviceMesh, axis: str):
        super().__init__(block.router, block.w_gate, block.w_up, block.w_down,
                         num_experts=block.num_experts, top_k=block.top_k, tile_m=block.tile_m,
                         prefill_threshold=block.prefill_threshold,
                         prefill_impl=block.prefill_impl, prefill_tile_m=block.prefill_tile_m,
                         capacity_factor=block.capacity_factor, moe_impl=block.moe_impl,
                         router_bias=block.router_bias, routed_scale=block.routed_scale,
                         first_expert=block.first_expert, shared=block.shared)
        self._mesh, self._axis = mesh, axis
        self._rank_first = axis_index(mesh, axis) * self.held
        ranks = axis_size(mesh, axis)
        if self.held * ranks != block.num_experts:
            raise ValueError(f"{self.held} local experts x {ranks} ranks != "
                             f"{block.num_experts} experts")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._with_shared(psum(self._routed(x), self._mesh, self._axis), x)

    def _first_held(self) -> int:
        return self.first_expert + self._rank_first


def place_model(model: QuantizedTransformer, mesh: DeviceMesh,
                expert_axis: str = "expert") -> QuantizedTransformer:
    """A copy of ``model`` holding this rank's share (:func:`model_pspecs`)
    on the rank's device, every ``MoEBlock`` an :class:`EPMoEBlock`;
    ``model`` is left as it was. Tensors already in place are shared, not
    copied (at one rank along `expert` the placed model holds the same
    tensors). The expert modules keep the whole stack's ``shape``, as the
    JAX package's static metadata does."""
    memo = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    placed = copy.deepcopy(model, memo)
    specs = model_pspecs(model, expert_axis)
    for name, buf in list(placed.named_buffers(remove_duplicate=False)):
        mod_name, _, attr = name.rpartition(".")
        # a per_tensor scalar describes no split dim: every rank keeps it
        spec = specs[name] if buf.dim() else None
        setattr(placed.get_submodule(mod_name), attr, shard_tensor(buf, mesh, spec))
    for blk in placed.blocks:
        if isinstance(blk.moe, MoEBlock):
            blk.moe = EPMoEBlock(blk.moe, mesh, expert_axis)
    return placed


def sharded_decode_step(
    model: QuantizedTransformer,   # placed with place_model
    mesh: DeviceMesh,
    tokens: torch.Tensor,          # [B_loc, T], this rank's data shard
    caches: Tuple,                 # per-layer QuantizedKVCache of the rank's B_loc slots
    positions: torch.Tensor,       # [B_loc, T] or [T]
    *,
    data_axis: str = "data",
):
    """One forward step of the sharded model. Returns (logits [B, T, V], the
    whole batch's, gathered over ``data_axis`` in rank order; the rank's
    caches, updated in place)."""
    if not all(isinstance(blk.moe, EPMoEBlock) for blk in model.blocks
               if isinstance(blk.moe, MoEBlock)):
        raise ValueError("place the model on the mesh with place_model first")
    logits, caches = model(tokens, caches, positions)
    if data_axis in mesh.mesh_dim_names:
        logits = all_gather_dim(logits, mesh, data_axis, 0)
    return logits, caches
