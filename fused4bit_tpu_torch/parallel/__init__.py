"""The parallel layer over ``torch.distributed``: device meshes, sharding
rules, expert-, tensor-, sequence- and pipeline-parallel functions, and the
sharded decode step that the serving engine's mesh mode runs.

Counterpart of ``fused4bit_tpu/parallel/``. SPMD with one process per rank:
:func:`multihost.initialize` joins the processes (NCCL for CUDA, gloo for
the CPU), :func:`make_mesh` names the mesh dims, every rank holds its own
shards, and collectives run on ``mesh.get_group(axis)``. Sums over ranks
meet in rank order (:func:`mesh.psum`), so replicated results are the same
bits on every rank.
"""
from . import multihost
from .expert_parallel import (
    moe_ep_a2a,
    moe_ep_a2a_dropless,
    moe_ep_replicated,
    moe_ep_replicated_body,
    moe_ep_ring,
    tp_int4_matmul,
    tp_int4_matmul_body,
)
from .mesh import best_mesh_shape, make_mesh, psum, sum_in_rank_order
from .pipeline import pipeline_stages, stack_stage_params
from .sequence import (
    ring_attention,
    ring_attention_quantized,
    sequence_sharded_attention,
    shard_cache_sequence,
    shard_sequence,
    ulysses_attention,
)
from .sharded_model import EPMoEBlock, model_pspecs, place_model, sharded_decode_step
from .sharding import (
    Shard,
    qt_pspec_experts,
    qt_pspec_out_dim,
    replicate,
    shard_qt_experts,
    shard_qt_out_dim,
    shard_tensor,
    unshard_tensor,
)

__all__ = [
    "EPMoEBlock",
    "Shard",
    "best_mesh_shape",
    "make_mesh",
    "model_pspecs",
    "moe_ep_a2a",
    "moe_ep_a2a_dropless",
    "moe_ep_replicated",
    "moe_ep_replicated_body",
    "moe_ep_ring",
    "multihost",
    "pipeline_stages",
    "place_model",
    "psum",
    "qt_pspec_experts",
    "qt_pspec_out_dim",
    "replicate",
    "ring_attention",
    "ring_attention_quantized",
    "sequence_sharded_attention",
    "shard_cache_sequence",
    "shard_qt_experts",
    "shard_qt_out_dim",
    "shard_sequence",
    "shard_tensor",
    "sharded_decode_step",
    "stack_stage_params",
    "sum_in_rank_order",
    "tp_int4_matmul",
    "tp_int4_matmul_body",
    "ulysses_attention",
    "unshard_tensor",
]
