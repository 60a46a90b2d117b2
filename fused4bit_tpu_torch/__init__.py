"""fused4bit_tpu_torch: the INT4 weight-only inference framework in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``fused4bit_tpu`` (JAX + Pallas for TPU), which stays beside it
as the reference. Same byte formats; the Pallas kernels of the serving path
(w4a16 and w4a8 linear and grouped products, INT4-KV attention) are CUDA C++
kernels in ``csrc/``, built with nvcc at first use (``ops._build``). The
execution modes of the JAX package are the converters ``as_turbo``,
``as_u4_turbo``, ``as_xla_turbo`` and ``as_per_group``. Entry points that
allocate build on the CUDA card unless given ``device="cpu"``. Imports
PyTorch and NumPy, never JAX.
"""
from .layers import (
    DenseLinear,
    DispatchPlan,
    MoEINT4,
    QuantizedKVCache,
    QuantizedLinear,
    RoutingResult,
    combine,
    dispatch,
    expert_load_stats,
    make_capacity_plan,
    make_dispatch_plan,
    topk_route,
)
from .models import (
    ModelConfig,
    MoEConfig,
    QuantizedTransformer,
    as_per_group,
    as_turbo,
    as_u4_turbo,
    as_xla_turbo,
    flagship_model_config,
    kv_cache_from_jax,
    model_from_jax,
)
from .ops import (
    Int8Resident,
    grouped_int4_matmul,
    grouped_int4_matmul_a8,
    grouped_int4_matmul_per_group,
    grouped_int4_matmul_per_group_a8,
    int4_decode_attention,
    int4_grouped_transient,
    int4_linear_transient,
    int4_matmul,
    int4_matmul_a8,
    int4_matmul_per_group,
    int4_matmul_per_group_a8,
    int4_prefill_attention,
    int8_grouped_capacity,
    int8_linear,
    to_int8_resident,
)
from .quant import QuantizedTensor, dequantize, pack_planar, quantize, reference_linear_qt, unpack_planar
from .serving import GenerationRequest, Sampler, ServingEngine, generate

__all__ = [
    "DenseLinear",
    "DispatchPlan",
    "GenerationRequest",
    "Int8Resident",
    "ModelConfig",
    "MoEConfig",
    "MoEINT4",
    "QuantizedKVCache",
    "QuantizedLinear",
    "QuantizedTensor",
    "QuantizedTransformer",
    "RoutingResult",
    "Sampler",
    "ServingEngine",
    "as_per_group",
    "as_turbo",
    "as_u4_turbo",
    "as_xla_turbo",
    "combine",
    "dequantize",
    "dispatch",
    "expert_load_stats",
    "flagship_model_config",
    "generate",
    "grouped_int4_matmul",
    "grouped_int4_matmul_a8",
    "grouped_int4_matmul_per_group",
    "grouped_int4_matmul_per_group_a8",
    "int4_decode_attention",
    "int4_grouped_transient",
    "int4_linear_transient",
    "int4_matmul",
    "int4_matmul_a8",
    "int4_matmul_per_group",
    "int4_matmul_per_group_a8",
    "int4_prefill_attention",
    "int8_grouped_capacity",
    "int8_linear",
    "kv_cache_from_jax",
    "make_capacity_plan",
    "make_dispatch_plan",
    "model_from_jax",
    "pack_planar",
    "quantize",
    "reference_linear_qt",
    "to_int8_resident",
    "topk_route",
    "unpack_planar",
]
