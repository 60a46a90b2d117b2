"""QuantizedDense: the JAX package's flax ``nn.Dense`` replacement, as an
``nn.Module``.

Counterpart of ``fused4bit_tpu/layers/flax_compat.py``. It draws a
lecun-normal kernel in flax's [K, N] convention (a truncated normal in ±2
standard deviations, scaled to variance 1/K, as ``nn.initializers.
lecun_normal``) from an explicit ``torch.Generator``, stores its transpose
quantized per row in the planar layout (the reference library's [N, K]),
and runs ``ops.int4_matmul`` (kernel K1 on the card, its plain version on
the CPU), plus an optional float32 bias. :meth:`QuantizedDense.from_kernel`
carries a flax Dense kernel across; ``models.from_jax.quantized_dense_from_jax``
reads a JAX ``QuantizedDense``'s variables byte for byte.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._device import resolve_device
from ..ops.int4_matmul import int4_matmul
from ..quant.core import QuantizedTensor, quantize

__all__ = ["QuantizedDense"]

# The standard deviation of a standard normal truncated to ±2, by which
# flax's variance_scaling divides so that the truncated draw has unit variance.
_TRUNC_STD = 0.87962566103423978


def lecun_normal(in_features: int, features: int, *, generator=None,
                 device=None) -> torch.Tensor:
    """A [K, N] float32 kernel with flax's lecun_normal distribution."""
    w = torch.empty((in_features, features), dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
    return w * ((1.0 / in_features) ** 0.5 / _TRUNC_STD)


class QuantizedDense(nn.Module):
    """``y = x @ dequant(W)^T (+ b)`` with INT4 per-row planar weights.

    ``in_features`` K, ``features`` N; ``use_bias`` adds a float32 bias,
    zeros at init. The kernel is drawn from ``generator`` on ``device``
    (None: the CUDA card).
    """

    def __init__(self, in_features: int, features: int, *, use_bias: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        kernel = lecun_normal(in_features, features, generator=generator, device=device)
        # a contiguous [N, K]: quantize packs in its input's memory order
        self._store(quantize(kernel.t().contiguous()),
                    torch.zeros((features,), device=device) if use_bias else None)

    def _store(self, weight: QuantizedTensor, bias: Optional[torch.Tensor]) -> None:
        self.register_buffer("packed", weight.packed)
        self.register_buffer("scales", weight.scales)
        self.register_buffer("zero_points", weight.zero_points)
        self.register_buffer("bias", bias)
        self.shape = tuple(weight.shape)

    @classmethod
    def from_kernel(cls, kernel_kn: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> "QuantizedDense":
        """A layer holding a flax Dense kernel [K, N] (and bias [N]),
        quantized on the kernel's device."""
        return cls.from_weight(quantize(kernel_kn.float().t().contiguous()), bias)

    @classmethod
    def from_weight(cls, weight: QuantizedTensor,
                    bias: Optional[torch.Tensor] = None) -> "QuantizedDense":
        """A layer holding ``weight`` (per_row planar [N, K]) as it is."""
        if weight.granularity != "per_row" or weight.layout != "planar":
            raise ValueError(f"QuantizedDense holds per_row planar weights, got "
                             f"{weight.granularity} {weight.layout}")
        layer = cls.__new__(cls)
        nn.Module.__init__(layer)
        layer._store(weight, None if bias is None else bias.float())
        return layer

    @property
    def weight(self) -> QuantizedTensor:
        return QuantizedTensor(self.packed, self.scales, self.zero_points, self.shape,
                               block_k=self.shape[-1])

    @property
    def in_features(self) -> int:
        return self.shape[1]

    @property
    def features(self) -> int:
        return self.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int4_matmul(x, self.weight)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, features={self.features}, "
                f"bias={self.bias is not None}")
