"""fused4bit_tpu_torch: the INT4 weight-only inference framework in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``fused4bit_tpu`` (JAX + Pallas for TPU), which stays beside it
as the reference. Same byte formats; the three Pallas kernels of the serving
path are CUDA C++ kernels in ``csrc/``, built with nvcc at first use
(``ops._build``). Imports PyTorch and NumPy, never JAX.
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
    make_dispatch_plan,
    topk_route,
)
from .models import (
    ModelConfig,
    MoEConfig,
    QuantizedTransformer,
    flagship_model_config,
    kv_cache_from_jax,
    model_from_jax,
)
from .ops import (
    grouped_int4_matmul,
    int4_decode_attention,
    int4_matmul,
    int4_prefill_attention,
)
from .quant import QuantizedTensor, dequantize, pack_planar, quantize, reference_linear_qt, unpack_planar
from .serving import GenerationRequest, Sampler, ServingEngine, generate

__all__ = [
    "DenseLinear",
    "DispatchPlan",
    "GenerationRequest",
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
    "combine",
    "dequantize",
    "dispatch",
    "flagship_model_config",
    "generate",
    "grouped_int4_matmul",
    "int4_decode_attention",
    "int4_matmul",
    "int4_prefill_attention",
    "kv_cache_from_jax",
    "make_dispatch_plan",
    "model_from_jax",
    "pack_planar",
    "quantize",
    "reference_linear_qt",
    "topk_route",
    "unpack_planar",
]
