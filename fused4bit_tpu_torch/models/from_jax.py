"""Convert the JAX package's model and KV cache into this package's modules.

The input is a flat ``{keypath: numpy array}`` dict whose keys are the
``jax.tree_util.keystr`` paths of the JAX pytree leaves (``.embed``,
``.blocks[0].attn.wq.weight.packed``, ``[0].k_packed``, ...), as
``jax.tree_util.tree_flatten_with_path`` produces them. The arrays are
taken byte for byte: both packages then compute the same function on the
same bytes. This module imports no JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..layers.kv_cache import QuantizedKVCache
from ..layers.linear import QuantizedLinear
from ..layers.moe import MoEINT4
from ..quant.core import QuantizedTensor
from .config import ModelConfig
from .transformer import Attention, MoEBlock, QuantizedTransformer, TransformerBlock

__all__ = ["model_from_jax", "kv_cache_from_jax"]

Params = Dict[str, np.ndarray]


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: move the raw bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _qt(params: Params, prefix: str, device) -> QuantizedTensor:
    packed = _tensor(params[f"{prefix}.packed"], device)
    shape = tuple(packed.shape[:-1]) + (packed.shape[-1] * 2,)
    return QuantizedTensor(
        packed=packed,
        scales=_tensor(params[f"{prefix}.scales"], device).float(),
        zero_points=_tensor(params[f"{prefix}.zero_points"], device).float(),
        shape=shape,
        block_k=shape[-1],
    )


def _linear(params: Params, prefix: str, device) -> QuantizedLinear:
    bias = params.get(f"{prefix}.bias")
    return QuantizedLinear(_qt(params, f"{prefix}.weight", device),
                           None if bias is None else _tensor(bias, device))


def model_from_jax(params: Params, cfg: ModelConfig, device=None) -> QuantizedTransformer:
    """The port's ``QuantizedTransformer`` holding the JAX model's leaves."""
    blocks = []
    for i in range(cfg.num_layers):
        p = f".blocks[{i}]"
        attn = Attention(
            *(_linear(params, f"{p}.attn.{w}", device) for w in ("wq", "wk", "wv", "wo")),
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        )
        moe = MoEBlock(
            _linear(params, f"{p}.moe.router", device),
            *(MoEINT4(_qt(params, f"{p}.moe.{w}.weight", device))
              for w in ("w_gate", "w_up", "w_down")),
            num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
        )
        blocks.append(TransformerBlock(
            _tensor(params[f"{p}.attn_norm"], device), attn,
            _tensor(params[f"{p}.moe_norm"], device), moe, rms_eps=cfg.rms_eps,
        ))
    return QuantizedTransformer(
        _tensor(params[".embed"], device), blocks,
        _tensor(params[".final_norm"], device),
        _linear(params, ".lm_head", device), rms_eps=cfg.rms_eps,
    )


def kv_cache_from_jax(params: Params, prefix: str = "", device=None) -> QuantizedKVCache:
    """The port's ``QuantizedKVCache`` holding a JAX cache's leaves; ``prefix``
    selects one layer of a tuple of caches (``"[0]"``)."""
    return QuantizedKVCache(*(
        _tensor(params[f"{prefix}.{f}"], device) for f in QuantizedKVCache._FIELDS
    ))
