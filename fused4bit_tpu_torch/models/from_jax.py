"""Convert the JAX package's model and KV cache into this package's modules.

The input is a flat ``{keypath: numpy array}`` dict whose keys are the
``jax.tree_util.keystr`` paths of the JAX pytree leaves (``.embed``,
``.blocks[0].attn.wq.weight.packed``, ``[0].k_packed``, ...), as
``jax.tree_util.tree_flatten_with_path`` produces them. The arrays are
taken byte for byte: both packages then compute the same function on the
same bytes. Every leaf is consumed or the conversion raises, so nothing the
JAX model holds is lost silently. A JAX execution mode is partly static
(fields that are not leaves), so it is named by ``mode``. So is a weight's
format: granularity, layout and group size are static fields of the JAX
``QuantizedTensor``, so each weight's format is read from its site (a linear
or an expert stack) and its leaves' shapes (per_row, per_tensor, per_group;
planar_groups has a shape of its own), and a shape that fits no format of
the site raises. The planar, interleaved and block_planar layouts hold the
same shapes, so the layout of those bytes is named by ``layout``. A linear
the JAX model holds dense (``DenseLinear``: the router and, with
``quantize_lm_head=False``, the lm_head of ``models.convert``) has a
``.weight`` leaf of its own and is read as the port's ``DenseLinear``. This
module imports no JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from ..layers.kv_cache import QuantizedKVCache
from ..layers.linear import DenseLinear, QuantizedLinear
from ..layers.moe import MoEINT4
from ..layers.paged_kv import PagedKVCache
from ..ops.int8_xla import Int8Resident
from ..quant.core import QuantizedTensor
from .config import ModelConfig
from .transformer import (
    Attention,
    MoEBlock,
    QuantizedTransformer,
    TransformerBlock,
    as_per_group,
    as_turbo,
    as_u4_turbo,
    as_xla_turbo,
)

__all__ = ["model_from_jax", "kv_cache_from_jax"]

Params = Dict[str, np.ndarray]

_CONVERTERS = {
    "kernel": lambda model: model,
    "u4_turbo": as_u4_turbo,
    "turbo": as_turbo,
    "xla_turbo": as_xla_turbo,
    "per_group": as_per_group,
    "pg_turbo": lambda model, group_size=128: as_turbo(as_per_group(model, group_size)),
}
_PER_GROUP_MODES = ("per_group", "pg_turbo")


class _Reader:
    """The leaves, with a record of which keys were read."""

    def __init__(self, params: Params, device, per_group: bool, layout: str,
                 block_k: Optional[int]):
        self.params = params
        self.device = device
        self.per_group = per_group  # whether per-group leaves may be read
        self.layout = layout        # the layout of [..., N, K/2] bytes
        self.block_k = block_k
        self.used = set()
        self.group_sizes = set()

    def __call__(self, key: str) -> torch.Tensor:
        self.used.add(key)
        return _tensor(self.params[key], self.device)

    def get(self, key: str) -> Optional[torch.Tensor]:
        return self(key) if key in self.params else None


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)   # not ascontiguousarray: it makes a 0-d leaf (a per_tensor scale) 1-d
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: move the raw bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _qt(read: _Reader, prefix: str, lead: int) -> QuantizedTensor:
    """The QuantizedTensor at ``prefix``: a linear (``lead`` 0) or an expert
    stack (``lead`` 1). packed [*lead, N, K/2] in ``read.layout``: per_row
    with scales [*lead, N], per_tensor with scales [*lead], per_group with
    scales [*lead, N, K/gs]. per_group planar_groups: packed
    [*lead, Gh, N, gs], scales [*lead, N, 2*Gh]."""
    packed = read(f"{prefix}.packed")
    scales = read(f"{prefix}.scales").float()
    zero_points = read(f"{prefix}.zero_points").float()
    p, sc = tuple(packed.shape), tuple(scales.shape)
    ok = tuple(zero_points.shape) == sc and packed.dtype == torch.uint8
    if ok and len(p) == lead + 2:
        k = 2 * p[-1]
        fmt = dict(layout=read.layout, block_k={"planar": k, "interleaved": read.block_k or 0,
                                                "block_planar": read.block_k or k}[read.layout])
        if sc == p[:-1]:
            return QuantizedTensor(packed, scales, zero_points, p[:-1] + (k,), **fmt)
        if sc == p[:lead]:
            return QuantizedTensor(packed, scales, zero_points, p[:-1] + (k,),
                                   granularity="per_tensor", **fmt)
        g = sc[-1]
        if len(sc) == lead + 2 and sc[:-1] == p[:-1] and g % 2 == 0 and k % g == 0:
            return _per_group(read, prefix, p, QuantizedTensor(   # Gh = g/2 groups per half
                packed, scales, zero_points, p[:-1] + (k,), granularity="per_group",
                group_size=k // g, **fmt))
    if ok and len(p) == lead + 3 and sc == p[:lead] + (p[-2], 2 * p[-3]):
        gh, n, gs = p[-3:]
        shape = p[:lead] + (n, 2 * gh * gs)
        return _per_group(read, prefix, p, QuantizedTensor(
            packed, scales, zero_points, shape, granularity="per_group", layout="planar_groups",
            block_k=shape[-1], group_size=gs))
    raise ValueError(f"{prefix}: packed {p} {packed.dtype}, scales {sc}, zero_points "
                     f"{tuple(zero_points.shape)} fit no format (per_row, per_tensor or "
                     "per_group over [..., N, K/2] bytes, or per_group planar_groups)")


def _per_group(read: _Reader, prefix: str, p, qt: QuantizedTensor) -> QuantizedTensor:
    if not read.per_group:
        raise ValueError(f"{prefix}.packed holds per-group weights {p}: read them with "
                         f"mode={_PER_GROUP_MODES}")
    read.group_sizes.add(qt.group_size)
    return qt


def _w8(read: _Reader, prefix: str, with_w8: bool) -> Optional[Int8Resident]:
    """The JAX i8-resident copy, byte for byte (xla_turbo only)."""
    if not with_w8 or f"{prefix}.w8.q8" not in read.params:
        return None
    return Int8Resident(read(f"{prefix}.w8.q8"), read(f"{prefix}.w8.scales"))


def _linear(read: _Reader, prefix: str, with_w8: bool) -> Union[QuantizedLinear, DenseLinear]:
    if f"{prefix}.weight" in read.params:   # a dense leaf: DenseLinear
        return DenseLinear(read(f"{prefix}.weight"), read.get(f"{prefix}.bias"))
    return QuantizedLinear(_qt(read, f"{prefix}.weight", 0), read.get(f"{prefix}.bias"),
                           w8=_w8(read, prefix, with_w8))


def _experts(read: _Reader, prefix: str, with_w8: bool) -> MoEINT4:
    return MoEINT4(_qt(read, f"{prefix}.weight", 1), w8=_w8(read, prefix, with_w8))


def model_from_jax(params: Params, cfg: ModelConfig, device=None, *, mode: str = "kernel",
                   layout: str = "planar", block_k: Optional[int] = None
                   ) -> QuantizedTransformer:
    """The port's ``QuantizedTransformer`` holding the JAX model's leaves.

    ``mode``: the JAX execution mode the leaves come from ("kernel", the
    default; "u4_turbo", "turbo" or "xla_turbo", the JAX converters of the
    same names; "per_group", ``as_per_group``, and "pg_turbo", ``as_turbo``
    after ``as_per_group``). The model is built from the bytes, then the
    port's converter of that name is applied (``as_per_group`` keeps the
    leaves that are per-group already: it requantizes nothing the JAX model
    converted); for "xla_turbo" the JAX ``.w8.q8`` / ``.w8.scales`` leaves
    are loaded as the i8-resident copies, not recomputed. A model from the
    JAX ``convert_checkpoint`` is read with "kernel" (per row) or
    "per_group" (per group: planar leaves, K6 and K12, or the golden path).
    ``layout``: the layout of the weights stored as [..., N, K/2] bytes,
    "planar" (what the JAX converters produce), "interleaved" or
    "block_planar" (``block_k`` columns per block, K by default); it is a
    static field of the JAX weights, not a leaf. Raises
    ``ValueError`` naming any leaf left unconsumed (for example ``.w8``
    leaves passed with another mode), any weight whose shapes fit no format
    of its site, and per-group weights under a per-row mode. ``device``:
    None means the CUDA card.
    """
    if mode not in _CONVERTERS:
        raise ValueError(f"mode={mode!r} is not one of {sorted(_CONVERTERS)}")
    if layout not in ("planar", "interleaved", "block_planar"):
        raise ValueError(f"layout={layout!r} is not 'planar', 'interleaved' or 'block_planar'")
    read = _Reader(params, resolve_device(device), mode in _PER_GROUP_MODES, layout, block_k)
    with_w8 = mode == "xla_turbo"
    blocks = []
    for i in range(cfg.num_layers):
        p = f".blocks[{i}]"
        attn = Attention(
            *(_linear(read, f"{p}.attn.{w}", with_w8) for w in ("wq", "wk", "wv", "wo")),
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        )
        moe = MoEBlock(
            _linear(read, f"{p}.moe.router", with_w8),
            *(_experts(read, f"{p}.moe.{w}", with_w8) for w in ("w_gate", "w_up", "w_down")),
            num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
        )
        blocks.append(TransformerBlock(
            read(f"{p}.attn_norm"), attn, read(f"{p}.moe_norm"), moe, rms_eps=cfg.rms_eps,
        ))
    model = QuantizedTransformer(
        read(".embed"), blocks, read(".final_norm"), _linear(read, ".lm_head", with_w8),
        rms_eps=cfg.rms_eps,
    )
    unread = sorted(set(params) - read.used)
    if unread:
        raise ValueError(
            f"model_from_jax(mode={mode!r}) left {len(unread)} leaves unconsumed: "
            f"{unread[:8]}{' ...' if len(unread) > 8 else ''}"
        )
    if mode in _PER_GROUP_MODES:
        if len(read.group_sizes) > 1:
            raise ValueError(f"per-group leaves of several group sizes {sorted(read.group_sizes)}")
        return _CONVERTERS[mode](model, *read.group_sizes)
    return _CONVERTERS[mode](model)


def kv_cache_from_jax(params: Params, prefix: str = "",
                      device=None) -> Union[QuantizedKVCache, PagedKVCache]:
    """The port's cache holding a JAX cache's leaves, byte for byte: a
    ``PagedKVCache`` when the leaves hold a ``page_table``, else a
    ``QuantizedKVCache``. ``prefix`` selects one layer of a tuple of caches
    (``"[0]"``); ``device`` None means the CUDA card."""
    device = resolve_device(device)
    cls = PagedKVCache if f"{prefix}.page_table" in params else QuantizedKVCache
    return cls(*(_tensor(params[f"{prefix}.{f}"], device) for f in cls._FIELDS))
