"""QuantizedLinear and DenseLinear as ``nn.Module``s.

Counterpart of ``fused4bit_tpu/layers/linear.py``. The packed weight, its
scales and zero points are registered buffers, so ``.to(device)`` moves them
and ``state_dict()`` holds them. The forward runs ``ops.int4_matmul``: kernel
K1 on a CUDA tensor, its plain version on a CPU tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.int4_matmul import int4_matmul
from ..quant.core import QuantizedTensor, quantize

__all__ = ["QuantizedLinear", "DenseLinear"]


class DenseLinear(nn.Module):
    """Unquantized linear, for layers a mixed-precision policy keeps dense."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weight", weight)   # [N, K]
        self.register_buffer("bias", bias)

    @property
    def in_dim(self) -> int:
        return self.weight.shape[1]

    @property
    def out_dim(self) -> int:
        return self.weight.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight.t().to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class QuantizedLinear(nn.Module):
    """INT4 weight-only linear layer: ``y = x @ dequant(W)^T (+ b)``.

    ``out_features``: the logical output width when the stored rows are
    padded; outputs are sliced back to it.
    """

    def __init__(
        self,
        weight: QuantizedTensor,
        bias: Optional[torch.Tensor] = None,
        *,
        out_features: Optional[int] = None,
    ):
        super().__init__()
        if weight.granularity != "per_row" or weight.layout != "planar":
            raise NotImplementedError("only per_row/planar weights are ported")
        self.register_buffer("packed", weight.packed)
        self.register_buffer("scales", weight.scales)
        self.register_buffer("zero_points", weight.zero_points)
        self.register_buffer("bias", bias)
        self.shape: Tuple[int, ...] = tuple(weight.shape)
        self.bits = weight.bits
        self.out_features = out_features

    @classmethod
    def from_dense(cls, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   **kw) -> "QuantizedLinear":
        """Quantize a dense [N, K] weight (per_row, planar)."""
        return cls(quantize(weight), bias, **kw)

    @classmethod
    def init(cls, in_dim: int, out_dim: int, *, generator: Optional[torch.Generator] = None,
             device=None, bias: bool = False) -> "QuantizedLinear":
        """Random N(0, 1/in_dim) weight, drawn from ``generator`` on ``device``."""
        w = torch.randn((out_dim, in_dim), generator=generator, device=device,
                        dtype=torch.float32) * (in_dim ** -0.5)
        b = torch.zeros((out_dim,), device=device) if bias else None
        return cls.from_dense(w, b)

    @property
    def weight(self) -> QuantizedTensor:
        return QuantizedTensor(self.packed, self.scales, self.zero_points, self.shape,
                               block_k=self.shape[-1], bits=self.bits)

    @property
    def in_dim(self) -> int:
        return self.shape[-1]

    @property
    def out_dim(self) -> int:
        return self.out_features or self.shape[-2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int4_matmul(x, self.weight)
        if self.out_features and y.shape[-1] != self.out_features:
            y = y[..., : self.out_features]
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def extra_repr(self) -> str:
        return (f"in={self.in_dim}, out={self.out_dim}, bits={self.bits}, "
                f"granularity=per_row, bias={self.bias is not None}")
