from .kv_cache import QuantizedKVCache
from .linear import DenseLinear, QuantizedLinear
from .paged_kv import PagedKVCache
from .moe import (
    DispatchPlan,
    MoEINT4,
    RoutingResult,
    combine,
    dispatch,
    expert_load_stats,
    make_capacity_plan,
    make_dispatch_plan,
    topk_route,
)

__all__ = [
    "DenseLinear",
    "DispatchPlan",
    "MoEINT4",
    "PagedKVCache",
    "QuantizedKVCache",
    "QuantizedLinear",
    "RoutingResult",
    "combine",
    "dispatch",
    "expert_load_stats",
    "make_capacity_plan",
    "make_dispatch_plan",
    "topk_route",
]
