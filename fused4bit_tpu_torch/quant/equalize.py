"""Activation-aware weight equalization (AWQ-style) for INT4 conversion.

Counterpart of ``fused4bit_tpu/quant/equalize.py``, with its constants and
its decisions. Input channels of a weight are scaled up where calibration
activations are large, so that their quantized values carry more precision,
and the inverse scale is folded into the preceding RMSNorm weight, an exact
reparameterization in full precision:

    y = rms(x) * gamma @ W^T  ==  rms(x) * (gamma / s) @ (W * s)^T

Only norm-preceded linears take part: q/k/v (folded into ``attn_norm``),
the MoE router and the experts' gate and up projections (``moe_norm``), and
the lm_head (``final_norm``). The dense router is compensated but does not
inform the scale. Per site, the exponent alpha is grid-searched to minimize
the INT4 reconstruction error of the quantized consumers on the captured
calibration activations,

    s(alpha) = act_amax^alpha / w_absmax^(1-alpha)     (geomean-normalized)
    err(alpha) = || x @ (dq(q(W*s)) / s)^T  -  x @ W^T ||^2,

and the identity is kept unless a rescaling beats it by more than 10 %.

The activations come from the capture taps of the float32 dense twin
(``models.dense_baseline``). The JAX package calibrates through the twin's
``gather`` MoE, which copies one expert weight per (token, k) pair; at the
Mixtral-8x7B layer widths that is 235 MB per pair, so this module runs the
``dense_all`` twin, the same function summed in another order.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .core import dequantize, quantize
from .reference import full_precision

__all__ = ["EqualizedCheckpoint", "awq_equalize_params", "awq_site_scale"]

_ALPHAS = (0.0, 0.25, 0.5, 0.75, 1.0)
_CLIP = (0.1, 10.0)
_ERR_ROWS = 512      # rows of each consumer that the reconstruction error reads


def _geomean_normalize(s: torch.Tensor) -> torch.Tensor:
    s = torch.clamp(s, min=1e-8)
    s = s / torch.exp(torch.mean(torch.log(s)))
    return torch.clamp(s, *_CLIP)


def _recon_err(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
               granularity: str, group_size: int) -> float:
    """INT4 reconstruction error of x @ W^T when W is quantized as W*s."""
    qt = quantize((w * s[None, :]).float(), granularity=granularity, layout="planar",
                  group_size=group_size)
    wd = dequantize(qt, dtype=torch.float32) / s[None, :]
    with full_precision():
        err = x @ wd.t() - x @ w.t()
    return float(torch.sum(err * err))


def _site_choice(x: torch.Tensor, weights, *, granularity: str = "per_row",
                 group_size: int = 128, alpha: Optional[float] = None,
                 max_rows: int = 256) -> Tuple[Optional[float], torch.Tensor]:
    """(alpha, scale) of one norm site: the pinned ``alpha``, else the grid's
    winner, or (None, ones) where the identity wins."""
    x = x.reshape(-1, x.shape[-1]).float()
    if x.shape[0] > max_rows:
        idx = np.linspace(0, x.shape[0] - 1, max_rows).astype(np.int32)
        x = x[torch.from_numpy(idx).long().to(x.device)]
    act = torch.clamp(torch.mean(x.abs(), dim=0), min=1e-8)                   # [K]
    flat = [w.reshape(-1, w.shape[-1]).float() for w in weights]
    wmax = torch.clamp(torch.stack([w.abs().amax(dim=0) for w in flat]).amax(dim=0),
                       min=1e-8)                                            # [K]

    def scale_for(a: float) -> torch.Tensor:
        return _geomean_normalize((act ** a) / (wmax ** (1.0 - a)))

    if alpha is not None:
        return alpha, scale_for(alpha)
    # the error on the first rows of every consumer at once (a joint choice);
    # the identity must be beaten by more than 10 %: on models without
    # salient channels small calibration gains do not generalize
    w_err = torch.cat([w[:_ERR_ROWS] for w in flat])
    ident = torch.ones_like(act)
    best = (None, ident, 0.9 * _recon_err(x, w_err, ident, granularity, group_size))
    for a in _ALPHAS:
        s = scale_for(a)
        e = _recon_err(x, w_err, s, granularity, group_size)
        if e < best[2]:
            best = (a, s, e)
    return best[0], best[1]


def awq_site_scale(x: torch.Tensor, weights, *, granularity: str = "per_row",
                   group_size: int = 128, alpha: Optional[float] = None,
                   max_rows: int = 256) -> torch.Tensor:
    """Per-input-channel scale [K] for one norm site: ``x`` [..., K] the
    calibration activations, ``weights`` the quantized consumers ([N, K] or
    [E, N, K] each); ``alpha`` None grid-searches."""
    return _site_choice(x, weights, granularity=granularity, group_size=group_size,
                        alpha=alpha, max_rows=max_rows)[1]


class EqualizedCheckpoint(Mapping):
    """A checkpoint mapping read through AWQ's per-channel scales: a weight
    of a scaled site is read from ``params``, multiplied by its column scales
    (a norm: divided by them) in float64 and rounded to float32, as the JAX
    package does, each time it is read. No second copy of the checkpoint
    exists. Other keys read as ``params`` holds them. ``alphas``: each
    site's alpha (None: the identity, whose weights read unchanged)."""

    def __init__(self, params: Mapping, scales: Dict[str, torch.Tensor],
                 divisors: Dict[str, torch.Tensor], alphas: Dict[str, Optional[float]]):
        self.params, self.scales, self.divisors, self.alphas = params, scales, divisors, alphas

    def __getitem__(self, key):
        a = self.params[key]
        if key not in self.scales and key not in self.divisors:
            return a
        s = self.scales.get(key, self.divisors.get(key))
        w = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a, np.float64))
        w = w.to(device=s.device, dtype=torch.float64)
        out = w * s.double()[None, :] if key in self.scales else w / s.double()
        return out.float()

    def __iter__(self):
        return iter(self.params)

    def __len__(self):
        return len(self.params)


def _calibrate(params: Mapping, cfg, tokens, device,
               moe_impl: str = "dense_all") -> Tuple[torch.nn.Module, List[tuple]]:
    """The float32 dense twin of ``params`` on ``device`` and its capture
    taps' outputs over ``tokens`` [B, T] (or [T]), in JAX's order: per block
    ("attn_in", h) and ("moe_in", h), then ("final_in", x)."""
    from ..models.dense_baseline import dense_from_params

    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens, np.int64))
    tokens = tokens.to(device=device, dtype=torch.long)
    if tokens.dim() == 1:
        tokens = tokens[None]
    b, t = tokens.shape
    twin = dense_from_params(params, cfg, dtype=torch.float32, moe_impl=moe_impl, device=device)
    caches = twin.init_cache(cfg, b, max(2, (t + 1) // 2 * 2), torch.float32)
    positions = torch.arange(t, device=device)[None].expand(b, t)
    capture = []
    with torch.no_grad(), full_precision():
        twin(tokens, caches, positions, capture=capture)
    return twin, capture


def awq_equalize_params(params: Mapping, cfg, tokens, *, granularity: str = "per_row",
                        group_size: int = 128, alpha: Optional[float] = None,
                        quantize_lm_head: bool = True, device=None) -> EqualizedCheckpoint:
    """Equalize a flat dense-weight mapping (the key schema of
    ``models.convert``) before quantization, calibrated on ``tokens`` [B, T]
    through the float32 dense twin on ``device`` (None: the CUDA card).

    Returns an :class:`EqualizedCheckpoint`: the same function in full
    precision, with weights scaled per input channel and the preceding norms
    divided, read one weight at a time. The twin is freed before it returns.
    """
    from .._device import resolve_device

    twin, capture = _calibrate(params, cfg, tokens, resolve_device(device))
    kw = dict(granularity=granularity, group_size=group_size, alpha=alpha)
    scales, divisors, alphas = {}, {}, {}

    def site(name, x, weights, scaled, norm):
        a, s = _site_choice(x, weights, **kw)
        alphas[name] = a
        if a is not None:
            scales.update(dict.fromkeys(scaled, s))
            divisors[norm] = s

    per_block = [h for tap, h in capture if tap != "final_in"]
    with torch.no_grad():
        for layer, blk in enumerate(twin.blocks):
            pre = f"layers.{layer}"
            site(f"{pre}.attn", per_block[2 * layer], [blk.wq, blk.wk, blk.wv],
                 [f"{pre}.attn.{p}_proj.weight" for p in "qkv"], f"{pre}.attn_norm.weight")
            experts = [f"{pre}.moe.experts.{i}.{w}.weight"
                       for i in range(cfg.moe.num_experts) for w in ("w1", "w3")]
            site(f"{pre}.moe", per_block[2 * layer + 1], list(blk.w_gate) + list(blk.w_up),
                 experts + [f"{pre}.moe.router.weight"], f"{pre}.moe_norm.weight")
        if quantize_lm_head:
            site("lm_head", capture[-1][1], [twin.lm_head], ["lm_head.weight"],
                 "final_norm.weight")
    del twin, capture
    return EqualizedCheckpoint(params, scales, divisors, alphas)
