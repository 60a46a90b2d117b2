"""Emulated FP4 (E2M1) quantization.

Counterpart of ``fused4bit_tpu/quant/fp4.py``: the true E2M1 value grid
±{0, .5, 1, 1.5, 2, 3, 4, 6}, one absmax scale per trailing [N, K] matrix
(per expert of a stack), codes ``sign << 3 | magnitude index`` held one per
uint8 (emulated: no packed 4-bit store). ``fp4_matmul`` dequantizes and
runs a float32 matmul, as the JAX function does outside any Pallas kernel.

Same codes and scales as the JAX package, bit for bit: the scale divides
absmax by a tensor 6 (on CUDA a Python-scalar divisor becomes a reciprocal
multiply, which rounds otherwise), and each code is the nearest grid
magnitude with ties to the lower one, which is what JAX's ``argmin`` over
the eight distances picks; here it is counted against the seven exact
midpoints, so no ``[..., 8]`` distance tensor is made (15 GB for a
Mixtral-width gate stack).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["FP4Tensor", "quantize_fp4", "dequantize_fp4", "fp4_matmul", "E2M1_VALUES"]

# The 8 non-negative E2M1 magnitudes; the full grid is ± these.
E2M1_VALUES = torch.tensor([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], dtype=torch.float32)
# Midpoints between neighbouring magnitudes, each exact in f32.
_MIDPOINTS = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)


@dataclasses.dataclass(frozen=True)
class FP4Tensor:
    """E2M1-coded tensor: uint8 codes (sign << 3 | magnitude index) and a
    float32 scale per leading index."""

    codes: torch.Tensor          # [..., N, K] u8, 4 significant bits (emulated)
    scale: torch.Tensor          # [...] f32
    shape: Tuple[int, ...]

    @property
    def nbytes_ideal(self) -> int:
        """Bytes a packed FP4 store would take (what the emulation models)."""
        n = 1
        for d in self.shape:
            n *= d
        return n // 2 + self.scale.numel() * 4


def quantize_fp4(w: torch.Tensor) -> FP4Tensor:
    """Round to the nearest E2M1 grid point after absmax scaling to ±6; each
    leading index (e.g. an expert) gets its own scale."""
    w = w.float()
    absmax = torch.amax(w.abs(), dim=(-2, -1))
    scale = torch.clamp(absmax, min=1e-8) / torch.full_like(absmax, 6.0)
    ws = w / scale[..., None, None]
    mag = ws.abs()
    # index of the nearest magnitude: the midpoints strictly below |ws|
    idx = torch.zeros(ws.shape, dtype=torch.uint8, device=ws.device)
    for m in _MIDPOINTS:
        idx += mag > m
    del mag
    codes = ((ws < 0).to(torch.uint8) << 3) | idx
    return FP4Tensor(codes=codes, scale=scale, shape=tuple(w.shape))


def dequantize_fp4(t: FP4Tensor, dtype=torch.float32) -> torch.Tensor:
    """The grid values times the scale, in ``dtype``."""
    mag = E2M1_VALUES.to(t.codes.device)[(t.codes & 0x7).long()]
    sign = torch.where((t.codes >> 3) > 0, -1.0, 1.0)
    return (sign * mag * t.scale[..., None, None]).to(dtype)


def fp4_matmul(x: torch.Tensor, t: FP4Tensor, dtype=None) -> torch.Tensor:
    """Dequantize, then a float32 matmul ``x @ w^T``; ``dtype`` out (x's by
    default)."""
    w = dequantize_fp4(t, dtype=torch.float32)
    out = torch.matmul(x.float(), w.transpose(-1, -2))
    return out.to(dtype or x.dtype)
