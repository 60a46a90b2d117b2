"""Peaks of the card and the operations and bytes that a step's work needs.

The peaks are NVIDIA's data sheet for the H100 SXM (dense rates, at the
full 700 W power limit): 3.35 TB/s of HBM3 and 989 TFLOP/s in bf16 on the
tensor cores. The counts are of what the inputs need, whatever kernel
does the work: each weight byte read once, each input row read once and
each output row written once. A linear's bytes follow
``fused4bit_tpu_torch/utils/roofline.py``'s ``linear_roofline`` (packed
weights, a scale and a zero point each as float32, x in, y out, bf16);
this module extends them to the experts a step's routing hit, to the INT4
KV cache that attention reads and to a whole decode step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
ACT_BYTES = 2            # bf16 activations


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def __iadd__(self, other: "Work") -> "Work":
        self.flops += other.flops
        self.bytes += other.bytes
        return self

    def bound_s(self) -> float:
        """The least time the card could take: the larger of the two bounds."""
        return max(self.flops / BF16_FLOPS_PER_S, self.bytes / HBM_BYTES_PER_S)


def weight_bytes(n: int, k: int, granularity: str, group_size: int) -> int:
    """Packed INT4 bytes of an [N, K] weight with its f32 scales and zero
    points (one pair per row, or per group of ``group_size`` columns)."""
    pairs = n if granularity == "per_row" else n * (k // group_size)
    return n * k // 2 + 8 * pairs


def kv_bytes_per_position(spec) -> int:
    """Bytes the INT4 KV cache holds for one position of one sequence over
    every layer: K and V codes (half a byte an element) and their four
    float32 scale and zero-point planes, per KV head."""
    return spec.layers * spec.kv_heads * (spec.head_dim + 4 * 4)


def model_bytes(spec) -> int:
    """Bytes of the served weights: every layer's packed INT4 projections,
    router and experts with their scales, the bf16 norms, the bf16
    embedding and the INT4 lm_head."""
    g, gs = spec.granularity, spec.group_size
    h, qd = spec.hidden, spec.heads * spec.head_dim
    kvd = spec.kv_heads * spec.head_dim
    layer = sum(weight_bytes(n, k, g, gs) for n, k in ((qd, h), (kvd, h), (kvd, h), (h, qd)))
    layer += weight_bytes(spec.experts, h, "per_row", gs)
    layer += spec.experts * (2 * weight_bytes(spec.ffn, h, g, gs) + weight_bytes(h, spec.ffn, g, gs))
    layer += 2 * h * ACT_BYTES
    return (spec.layers * layer + spec.vocab * h * ACT_BYTES + h * ACT_BYTES
            + weight_bytes(spec.vocab, h, g, gs))


def linear(m: int, n: int, k: int, granularity: str = "per_row", group_size: int = 128) -> Work:
    """One INT4 linear of M rows: y [M, N] = x [M, K] @ W^T."""
    return Work(flops=2.0 * m * n * k,
                bytes=weight_bytes(n, k, granularity, group_size) + ACT_BYTES * m * (k + n))


def grouped(tokens_per_expert: Sequence[int], n: int, k: int, granularity: str = "per_row",
            group_size: int = 128) -> Work:
    """One grouped projection: the weights of every expert that got a row,
    each routed row in and out once."""
    rows = sum(tokens_per_expert)
    hit = sum(1 for t in tokens_per_expert if t > 0)
    return Work(flops=2.0 * rows * n * k,
                bytes=hit * weight_bytes(n, k, granularity, group_size)
                + ACT_BYTES * rows * (k + n))


def attention(lengths: Sequence[int], heads: int, kv_heads: int, head_dim: int,
              queries: int = 1) -> Work:
    """Attention of ``queries`` rows per sequence over an INT4 KV cache of
    ``lengths`` positions: K and V codes (half a byte an element) and their
    four float32 scale and zero-point planes read up to each length, q in
    and out once; QK^T and PV at 2 operations a multiply-add."""
    pos = sum(lengths)
    cache = kv_heads * pos * (head_dim + 4 * 4)          # codes of K and V + 4 f32 planes
    qo = 2 * ACT_BYTES * len(lengths) * queries * heads * head_dim
    return Work(flops=4.0 * queries * heads * head_dim * pos, bytes=cache + qo)


def decode_step(spec, batch: int, lengths: Sequence[int],
                tokens_per_expert: Sequence[Sequence[int]]) -> Dict[str, Work]:
    """One decode step of ``batch`` sequences (one token each), by family:
    ``int4_matmul`` (attention projections, router, lm_head),
    ``grouped_matmul`` (gate, up and down over the experts hit, per layer
    from ``tokens_per_expert[layer]``), ``decode_attention`` (``lengths``:
    the positions each row attends, its own included), and ``step``: their
    sum with the new K/V written to the cache and the embedding rows read."""
    g, gs = spec.granularity, spec.group_size
    h, qd = spec.hidden, spec.heads * spec.head_dim
    kvd = spec.kv_heads * spec.head_dim
    lin, grp, att = Work(), Work(), Work()
    for layer in range(spec.layers):
        for n, k in ((qd, h), (kvd, h), (kvd, h), (h, qd)):
            lin += linear(batch, n, k, g, gs)
        lin += linear(batch, spec.experts, h, "per_row")
        tpe = tokens_per_expert[layer]
        grp += grouped(tpe, spec.ffn, h, g, gs)
        grp += grouped(tpe, spec.ffn, h, g, gs)
        grp += grouped(tpe, h, spec.ffn, g, gs)
        att += attention(lengths, spec.heads, spec.kv_heads, spec.head_dim)
    lin += linear(batch, spec.vocab, h, g, gs)
    step = Work()
    for w in (lin, grp, att):
        step += w
    # the step's new K/V (codes and planes) written, the embedding rows read
    step += Work(bytes=spec.layers * batch * 2 * spec.kv_heads * (spec.head_dim // 2 + 8)
                 + batch * h * ACT_BYTES)
    return {"int4_matmul": lin, "grouped_matmul": grp, "decode_attention": att, "step": step}
