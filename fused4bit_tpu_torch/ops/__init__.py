"""Ops over the hand-written CUDA kernels of ``csrc/``: each wrapper launches
its kernel on a CUDA tensor and runs its plain PyTorch version on a CPU one."""
from .decode_attention import (
    int4_attention,
    int4_attention_reference,
    int4_decode_attention,
    int4_prefill_attention,
)
from .grouped_matmul import grouped_int4_matmul, grouped_int4_matmul_reference
from .int4_matmul import int4_matmul, int4_matmul_reference

__all__ = [
    "grouped_int4_matmul",
    "grouped_int4_matmul_reference",
    "int4_attention",
    "int4_attention_reference",
    "int4_decode_attention",
    "int4_matmul",
    "int4_matmul_reference",
    "int4_prefill_attention",
]
