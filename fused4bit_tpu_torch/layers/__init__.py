from .flax_compat import QuantizedDense
from .kv_cache import LatentKVCache, QuantizedKVCache, dequantize_kv, quantize_kv
from .linear import DenseLinear, QuantizedLinear
from .paged_kv import PagedKVCache
from .moe import (
    DispatchPlan,
    MoEINT4,
    QuantizedMoE,
    RoutingResult,
    combine,
    dispatch,
    expert_load_stats,
    make_capacity_plan,
    make_dispatch_plan,
    simulate_router_logits,
    topk_route,
)

__all__ = [
    "DenseLinear",
    "DispatchPlan",
    "MoEINT4",
    "PagedKVCache",
    "QuantizedDense",
    "LatentKVCache",
    "QuantizedKVCache",
    "QuantizedLinear",
    "QuantizedMoE",
    "RoutingResult",
    "combine",
    "dequantize_kv",
    "dispatch",
    "expert_load_stats",
    "make_capacity_plan",
    "make_dispatch_plan",
    "quantize_kv",
    "simulate_router_logits",
    "topk_route",
]
