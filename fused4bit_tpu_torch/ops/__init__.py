"""Ops over the hand-written CUDA kernels of ``csrc/``: each wrapper launches
its kernel on a CUDA tensor and runs its plain PyTorch version on a CPU one.
``int8_xla`` holds the integer-GEMM paths, which have no kernel of their own."""
from .decode_attention import (
    int4_attention,
    int4_attention_reference,
    int4_decode_attention,
    int4_prefill_attention,
    paged_int4_attention,
    paged_int4_attention_reference,
    paged_int4_decode_attention,
    paged_int4_prefill_attention,
)
from .grouped_matmul import (
    grouped_int4_matmul,
    grouped_int4_matmul_a8,
    grouped_int4_matmul_a8_reference,
    grouped_int4_matmul_per_group,
    grouped_int4_matmul_per_group_a8,
    grouped_int4_matmul_per_group_a8_reference,
    grouped_int4_matmul_per_group_reference,
    grouped_int4_matmul_reference,
)
from .int4_matmul import (
    int4_matmul,
    int4_matmul_a8,
    int4_matmul_a8_reference,
    int4_matmul_per_group,
    int4_matmul_per_group_a8,
    int4_matmul_per_group_a8_reference,
    int4_matmul_per_group_reference,
    int4_matmul_reference,
)
from .int8_xla import (
    Int8Resident,
    int4_grouped_transient,
    int4_linear_transient,
    int8_grouped_capacity,
    int8_linear,
    to_int8_resident,
)

__all__ = [
    "Int8Resident",
    "grouped_int4_matmul",
    "grouped_int4_matmul_a8",
    "grouped_int4_matmul_a8_reference",
    "grouped_int4_matmul_per_group",
    "grouped_int4_matmul_per_group_a8",
    "grouped_int4_matmul_per_group_a8_reference",
    "grouped_int4_matmul_per_group_reference",
    "grouped_int4_matmul_reference",
    "int4_attention",
    "int4_attention_reference",
    "int4_decode_attention",
    "int4_grouped_transient",
    "int4_linear_transient",
    "int4_matmul",
    "int4_matmul_a8",
    "int4_matmul_a8_reference",
    "int4_matmul_per_group",
    "int4_matmul_per_group_a8",
    "int4_matmul_per_group_a8_reference",
    "int4_matmul_per_group_reference",
    "int4_matmul_reference",
    "int4_prefill_attention",
    "int8_grouped_capacity",
    "int8_linear",
    "paged_int4_attention",
    "paged_int4_attention_reference",
    "paged_int4_decode_attention",
    "paged_int4_prefill_attention",
    "to_int8_resident",
]
