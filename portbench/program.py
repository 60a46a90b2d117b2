"""The system under test: the port's model, built from the run's seeded
weights through the port's own layers and quantizer.

Each dense weight is drawn on the device (``inputs``), quantized by the
port (``QuantizedLinear.from_dense``, ``MoEINT4.from_dense``) in the
configuration's granularity, and freed, one tensor at a time, so the peak
stays near the packed model's size. The module tree is the one
``QuantizedTransformer.init`` builds; with ``granularity="per_group"``
the attention projections, experts and lm_head are per group
(planar_groups: K7 and K13) and the router stays per row, as
``as_per_group`` leaves it.
"""
from __future__ import annotations

import torch

from fused4bit_tpu_torch.layers.linear import QuantizedLinear
from fused4bit_tpu_torch.layers.moe import MoEINT4
from fused4bit_tpu_torch.models import ModelConfig, MoEConfig, QuantizedTransformer
from fused4bit_tpu_torch.models.transformer import Attention, MoEBlock, TransformerBlock
from fused4bit_tpu_torch.ops import _build

from . import inputs
from .inputs import ModelSpec


def csrc():
    """The folder of the port's CUDA sources (its kernels' names)."""
    return _build.CSRC


def model_config(spec: ModelSpec, name: str, max_seq: int) -> ModelConfig:
    """The port's ``ModelConfig`` for ``spec`` (what the engine reads)."""
    return ModelConfig(
        name=name,
        moe=MoEConfig(name, spec.experts, spec.hidden, spec.ffn, spec.top_k),
        num_layers=spec.layers, num_heads=spec.heads, num_kv_heads=spec.kv_heads,
        head_dim=spec.head_dim, vocab_size=spec.vocab, max_seq_len=max_seq,
        rope_theta=spec.rope_theta, rms_eps=spec.rms_eps)


def build(spec: ModelSpec, seed: int, device) -> QuantizedTransformer:
    kw = {} if spec.granularity == "per_row" else dict(granularity=spec.granularity,
                                                       group_size=spec.group_size)

    def linear(w, per_row=False):
        return QuantizedLinear.from_dense(w) if per_row else QuantizedLinear.from_dense(w, **kw)

    blocks = []
    for layer in range(spec.layers):
        def w(name):
            return inputs.layer_weight(spec, seed, layer, name, device)

        attn = Attention(linear(w("wq")), linear(w("wk")), linear(w("wv")), linear(w("wo")),
                         num_heads=spec.heads, num_kv_heads=spec.kv_heads,
                         head_dim=spec.head_dim, rope_theta=spec.rope_theta)
        moe = MoEBlock(linear(w("router"), per_row=True), MoEINT4.from_dense(w("w_gate"), **kw),
                       MoEINT4.from_dense(w("w_up"), **kw), MoEINT4.from_dense(w("w_down"), **kw),
                       num_experts=spec.experts, top_k=spec.top_k)
        ones = torch.ones((spec.hidden,), dtype=torch.bfloat16, device=device)
        blocks.append(TransformerBlock(ones, attn, ones.clone(), moe, rms_eps=spec.rms_eps))
    return QuantizedTransformer(inputs.embedding(spec, seed, device), blocks,
                                torch.ones((spec.hidden,), dtype=torch.bfloat16, device=device),
                                linear(inputs.lm_head(spec, seed, device)), rms_eps=spec.rms_eps)
