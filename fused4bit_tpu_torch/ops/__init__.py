"""Ops over the hand-written CUDA kernels of ``csrc/``: each wrapper launches
its kernel on a CUDA tensor and runs its plain PyTorch version on a CPU one.
``int8_xla`` holds the integer-GEMM paths, which have no kernel of their own.

Each wrapper counts its kernel's launches on an attribute of its own
(``int4_matmul.launches``, ...), each plain version and integer-GEMM path its
calls (``.calls``), one copy per process: :func:`launch_counts`,
:func:`plain_calls` and :func:`reset_counts` read and clear them all."""
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
    grouped_int4_matmul_per_group_planar_reference,
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
    int4_matmul_per_group_planar_reference,
    int4_matmul_per_group_reference,
    int4_matmul_reference,
    quantized_linear,
)
from .mla_attention import mla_attention, mla_attention_reference
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
    "grouped_int4_matmul_per_group_planar_reference",
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
    "int4_matmul_per_group_planar_reference",
    "int4_matmul_per_group_reference",
    "int4_matmul_reference",
    "int4_prefill_attention",
    "launch_counts",
    "mla_attention",
    "mla_attention_reference",
    "plain_calls",
    "reset_counts",
    "int8_grouped_capacity",
    "int8_linear",
    "paged_int4_attention",
    "paged_int4_attention_reference",
    "paged_int4_decode_attention",
    "paged_int4_prefill_attention",
    "quantized_linear",
    "to_int8_resident",
]

# (name, wrapper, attribute) of every kernel's launch counter; K1-K15, K3',
# then the share of K2's, K13's, K7's and K1's launches that ran the warpgroup body
# and the share of K3's and K3''s launches over a window layer's cache
_LAUNCH_COUNTERS = (
    ("int4_matmul", int4_matmul, "launches"),                                  # K1
    ("grouped_int4_matmul", grouped_int4_matmul, "launches"),                  # K2
    ("int4_attention", int4_attention, "launches"),                            # K3
    ("paged_int4_attention", paged_int4_attention, "launches"),                # K3'
    ("int4_matmul_a8", int4_matmul_a8, "launches"),                            # K4
    ("int4_matmul_a8_fused", int4_matmul_a8, "fused_launches"),                # K5
    ("grouped_int4_matmul_a8", grouped_int4_matmul_a8, "launches"),            # K10
    ("grouped_int4_matmul_a8_fused", grouped_int4_matmul_a8, "fused_launches"),  # K11
    ("int4_matmul_per_group", int4_matmul_per_group, "launches"),              # K7
    ("int4_matmul_per_group_a8", int4_matmul_per_group_a8, "launches"),        # K8
    ("grouped_int4_matmul_per_group", grouped_int4_matmul_per_group, "launches"),  # K13
    ("grouped_int4_matmul_per_group_a8", grouped_int4_matmul_per_group_a8, "launches"),  # K14
    ("int4_matmul_per_group_planar", int4_matmul_per_group, "planar_launches"),  # K6
    ("grouped_int4_matmul_ksplit", grouped_int4_matmul, "ksplit_launches"),    # K9
    ("grouped_int4_matmul_per_group_planar", grouped_int4_matmul_per_group,
     "planar_launches"),                                                        # K12
    ("grouped_int4_matmul_wg", grouped_int4_matmul, "wg_launches"),            # of K2
    ("grouped_int4_matmul_per_group_wg", grouped_int4_matmul_per_group,
     "wg_launches"),                                                            # of K13
    ("int4_matmul_per_group_wg", int4_matmul_per_group, "wg_launches"),        # of K7
    ("int4_matmul_wg", int4_matmul, "wg_launches"),                            # of K1
    ("int4_attention_window", int4_attention, "window_launches"),              # of K3
    ("paged_int4_attention_window", paged_int4_attention, "window_launches"),  # of K3'
    ("mla_attention", mla_attention, "launches"),                              # K15
)
_REFERENCES = (int4_matmul_reference, grouped_int4_matmul_reference, int4_attention_reference,
               paged_int4_attention_reference, int4_matmul_a8_reference,
               grouped_int4_matmul_a8_reference, int4_matmul_per_group_reference,
               int4_matmul_per_group_a8_reference, grouped_int4_matmul_per_group_reference,
               grouped_int4_matmul_per_group_a8_reference,
               int4_matmul_per_group_planar_reference,
               grouped_int4_matmul_per_group_planar_reference, mla_attention_reference)
_PATH_CALLS = (int4_linear_transient, int4_grouped_transient, int8_linear, int8_grouped_capacity)


def launch_counts() -> dict:
    """Every kernel's launches in this process since the last
    :func:`reset_counts`, by name."""
    return {name: getattr(fn, attr) for name, fn, attr in _LAUNCH_COUNTERS}


def plain_calls() -> int:
    """Calls of the kernels' plain versions since the last :func:`reset_counts`."""
    return sum(fn.calls for fn in _REFERENCES)


def reset_counts() -> None:
    """Set every launch counter, plain-version count and integer-GEMM path
    count to 0."""
    for _, fn, attr in _LAUNCH_COUNTERS:
        setattr(fn, attr, 0)
    for fn in _REFERENCES + _PATH_CALLS:
        fn.calls = 0
