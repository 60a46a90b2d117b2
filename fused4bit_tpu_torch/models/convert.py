"""Dense checkpoint -> INT4 model conversion (PyTorch).

Counterpart of ``fused4bit_tpu/models/convert.py``: a flat dict of dense
weights (a ``.safetensors`` file, or a ``state_dict``-style mapping of numpy
arrays or tensors) becomes a ``QuantizedTransformer`` with every projection
INT4, per row, per tensor or per group, optionally after AWQ equalization
(``quant.equalize``), under the JAX package's mixed-precision policy:
the MoE router stays dense (bf16) unless ``quantize_router``, the lm_head is
quantized unless ``quantize_lm_head=False``, the embedding and the norms are
kept in ``dtype``.

Each weight is moved to ``device``, quantized there, and dropped before the
next is read, so a full-width checkpoint never has to exist at once, on the
host or on the card: a ``params`` mapping whose ``__getitem__`` loads or
makes one weight at a time keeps the peak at one dense weight. The bytes are
the JAX package's: per row, its native packer gives ``quantize``'s bytes
(``tests/test_native.py``), which the port's ``quant.core.quantize``
reproduces; per group, the planar layout as in JAX, which runs kernels K6
(linears) and K12 (experts) where ``gs % 128 == 0`` divides K/2 and the
golden path otherwise; per tensor, the planar layout, which runs the golden
path (and the integer GEMMs under ``as_u4_turbo`` at prefill), as in JAX.

Expected key schema (HF-Mixtral-like, ``{L}`` = layer index, ``{E}`` =
expert):
  embed.weight                                  [V, H]
  layers.{L}.attn_norm.weight                   [H]
  layers.{L}.attn.{q,k,v,o}_proj.weight         [*, *]
  layers.{L}.moe_norm.weight                    [H]
  layers.{L}.moe.router.weight                  [E, H]
  layers.{L}.moe.experts.{E}.{w1,w2,w3}.weight  (w1=gate [F,H], w2=down [H,F], w3=up [F,H])
  final_norm.weight                             [H]
  lm_head.weight                                [V, H]
"""
from __future__ import annotations

import zlib
from collections.abc import Mapping
from typing import Union

import numpy as np
import torch

from .._device import resolve_device
from ..layers.linear import DenseLinear, QuantizedLinear
from ..layers.moe import MoEINT4
from ..quant.core import QuantizedTensor, quantize
from ..quant.equalize import awq_equalize_params
from .config import ModelConfig
from .transformer import Attention, MoEBlock, QuantizedTransformer, TransformerBlock

__all__ = ["quantize_dense_2d", "convert_checkpoint", "convert_safetensors", "checkpoint_shapes",
           "SeededCheckpoint"]

Array = Union[np.ndarray, torch.Tensor]


def _dense(a: Array, device: torch.device) -> torch.Tensor:
    """One checkpoint array as an f32 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)   # a copy: writable


def quantize_dense_2d(w: Array, device=None) -> QuantizedTensor:
    """Per-row INT4 planar quantization of a dense [N, K] array on ``device``
    (None: the CUDA card): the JAX package's bytes."""
    return quantize(_dense(w, resolve_device(device)))


def _stack(parts) -> QuantizedTensor:
    """Experts quantized one by one, stacked [E, ...]: the bytes of
    quantizing the stack at once (every scale belongs to one row)."""
    first = parts[0]
    return QuantizedTensor(
        torch.stack([p.packed for p in parts]), torch.stack([p.scales for p in parts]),
        torch.stack([p.zero_points for p in parts]), (len(parts),) + tuple(first.shape),
        granularity=first.granularity, layout=first.layout, block_k=first.block_k,
        group_size=first.group_size,
    )


def convert_safetensors(path: str, cfg: ModelConfig, dtype=torch.bfloat16,
                        **kw) -> QuantizedTransformer:
    """Load a .safetensors checkpoint (``models.safetensors_io``, NumPy on the
    host) and quantize it into an INT4 model. Extra kwargs (granularity,
    group_size, device, ...) pass through to :func:`convert_checkpoint`."""
    from .safetensors_io import load_safetensors

    return convert_checkpoint(load_safetensors(path), cfg, dtype=dtype, **kw)


def convert_checkpoint(
    params: Mapping[str, Array],
    cfg: ModelConfig,
    dtype=torch.bfloat16,
    *,
    quantize_router: bool = False,
    quantize_lm_head: bool = True,
    granularity: str = "per_row",
    group_size: int = 128,
    awq_tokens=None,
    awq_alpha=None,
    device=None,
) -> QuantizedTransformer:
    """Build an INT4 ``QuantizedTransformer`` from a flat dense-weight mapping.

    Mixed-precision policy, as in JAX: the MoE router defaults to DENSE
    (``DenseLinear`` in ``dtype``; ``quantize_router`` quantizes it per
    row), the lm_head is quantized unless ``quantize_lm_head=False``.
    ``granularity``: "per_row", "per_tensor" (one scale per weight, per
    expert in a stack) or "per_group" (groups of ``group_size`` columns), all
    planar. ``awq_tokens``: optional [B, T] calibration token ids; the
    weights are then equalized (``quant.equalize.awq_equalize_params``, the
    alpha of every site grid-searched unless ``awq_alpha`` pins it) and read
    through the scales one at a time, and the model's ``awq_alphas`` holds
    each site's alpha. ``device``: where the model is built, the calibration
    run and every weight quantized (None: the CUDA card; raises without one).
    """
    device = resolve_device(device)
    alphas = None
    if awq_tokens is not None:
        params = awq_equalize_params(params, cfg, awq_tokens, granularity=granularity,
                                     group_size=group_size, alpha=awq_alpha,
                                     quantize_lm_head=quantize_lm_head, device=device)
        alphas = params.alphas

    def qt(key: str) -> QuantizedTensor:
        return quantize(_dense(params[key], device), granularity=granularity,
                        layout="planar", group_size=group_size)

    def experts(pre: str, name: str) -> MoEINT4:
        return MoEINT4(_stack([qt(f"{pre}.moe.experts.{i}.{name}.weight")
                               for i in range(cfg.moe.num_experts)]))

    def router(key: str):
        if quantize_router:
            return QuantizedLinear(quantize(_dense(params[key], device)))
        return DenseLinear(_dense(params[key], device).to(dtype))

    def kept(key: str) -> torch.Tensor:
        return _dense(params[key], device).to(dtype)

    blocks = []
    for layer in range(cfg.num_layers):
        pre = f"layers.{layer}"
        attn = Attention(
            *(QuantizedLinear(qt(f"{pre}.attn.{p}_proj.weight")) for p in "qkvo"),
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta,
        )
        moe = MoEBlock(router(f"{pre}.moe.router.weight"), experts(pre, "w1"),
                       experts(pre, "w3"), experts(pre, "w2"),
                       num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k)
        blocks.append(TransformerBlock(kept(f"{pre}.attn_norm.weight"), attn,
                                       kept(f"{pre}.moe_norm.weight"), moe, rms_eps=cfg.rms_eps))
    lm_head = (QuantizedLinear(qt("lm_head.weight")) if quantize_lm_head
               else DenseLinear(kept("lm_head.weight")))
    model = QuantizedTransformer(kept("embed.weight"), blocks, kept("final_norm.weight"),
                                 lm_head, rms_eps=cfg.rms_eps)
    model.awq_alphas = alphas
    return model


def checkpoint_shapes(cfg):
    """Every key of the converter's checkpoint schema, with its shape."""
    hidden, hd = cfg.num_heads * cfg.head_dim, cfg.head_dim
    e, f = cfg.moe.num_experts, cfg.moe.ffn_dim
    shapes = {"embed.weight": (cfg.vocab_size, hidden), "final_norm.weight": (hidden,),
              "lm_head.weight": (cfg.vocab_size, hidden)}
    for layer in range(cfg.num_layers):
        pre = f"layers.{layer}"
        shapes.update({
            f"{pre}.attn_norm.weight": (hidden,), f"{pre}.moe_norm.weight": (hidden,),
            f"{pre}.attn.q_proj.weight": (cfg.num_heads * hd, hidden),
            f"{pre}.attn.k_proj.weight": (cfg.num_kv_heads * hd, hidden),
            f"{pre}.attn.v_proj.weight": (cfg.num_kv_heads * hd, hidden),
            f"{pre}.attn.o_proj.weight": (hidden, cfg.num_heads * hd),
            f"{pre}.moe.router.weight": (e, hidden),
        })
        for i in range(e):
            shapes[f"{pre}.moe.experts.{i}.w1.weight"] = (f, hidden)
            shapes[f"{pre}.moe.experts.{i}.w3.weight"] = (f, hidden)
            shapes[f"{pre}.moe.experts.{i}.w2.weight"] = (hidden, f)
    return shapes


class SeededCheckpoint(Mapping):
    """A random dense f32 checkpoint in the converter's schema, made on
    ``device`` one weight at a time: each key's weight is drawn, when it is
    read, from a ``torch.Generator`` seeded by ``seed`` and the key (N(0,
    1/K) weights, N(0, 0.02^2) embedding, norms of ones), so
    :func:`convert_checkpoint` quantizes and drops one weight at a time and
    no full-width checkpoint exists at once. ``device`` None: the CUDA
    card."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 11):
        self.shapes, self.device, self.seed = checkpoint_shapes(cfg), resolve_device(device), seed

    def __getitem__(self, key):
        shape = self.shapes[key]
        if key.endswith("norm.weight"):
            return torch.ones(shape, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed * 2 ** 32 + zlib.crc32(key.encode()))
        scale = 0.02 if key == "embed.weight" else shape[-1] ** -0.5
        return torch.randn(shape, generator=gen, device=self.device) * scale

    def __iter__(self):
        return iter(self.shapes)

    def __len__(self):
        return len(self.shapes)
