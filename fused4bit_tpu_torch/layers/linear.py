"""QuantizedLinear and DenseLinear as ``nn.Module``s.

Counterpart of ``fused4bit_tpu/layers/linear.py``. The packed weight, its
scales and zero points (and, in the xla_turbo mode, the i8-resident copy)
are registered buffers, so ``.to(device)`` moves them and ``state_dict()``
holds them. The forward follows the JAX layer's ``activation`` dispatch:

* ``"bf16"`` (default): ``ops.int4_matmul``, kernel K1;
* ``"int8"``: ``ops.int4_matmul_a8``, kernel K5 (or K4 at deep K);
* ``"int8_auto"`` (``as_u4_turbo``): ``"int8"`` below ``_AUTO_PREFILL_M``
  rows, ``"int8_transient"`` from there on;
* ``"int8_transient"``: ``ops.int4_linear_transient`` (unpack, int8 GEMM);
* ``"int8_xla"`` (``as_xla_turbo``): ``ops.int8_linear`` on the resident i8
  copy.

Per-group weights run ``ops.int4_matmul_per_group`` at every row count: K7
in the planar_groups layout, K6 in the planar layout (what ``models.convert``
produces); with ``"int8"``, planar_groups weights run
``ops.int4_matmul_per_group_a8`` (K8) and planar ones stay on K6, as in JAX;
``"int8_auto"`` sends per_row and per_tensor planar weights to the transient
path at 256 rows and above, never per-group ones.

Every format no kernel takes runs the golden path, dequantize and matmul,
as in the JAX package: per_tensor weights (except on the transient path),
the interleaved and block_planar layouts, per-group weights whose group
size is not a multiple of 128 or does not divide K/2, and any weight with
``use_kernel=False``. The golden path is the counted plain version
``ops.int4_matmul_reference`` (``ops.int4_matmul_per_group_reference`` for
per-group weights).

Each op runs its kernel on a CUDA tensor and its plain version on a CPU one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..ops.int4_matmul import (
    int4_matmul,
    int4_matmul_a8,
    int4_matmul_per_group,
    int4_matmul_per_group_a8,
    int4_matmul_per_group_reference,
    int4_matmul_reference,
)
from ..ops.int8_xla import (
    ROW_MULTIPLE,
    Int8Resident,
    int4_linear_transient,
    int8_linear,
    to_int8_resident,
)
from ..quant.core import QuantizedTensor, pad_rows, quantize
from ..utils.profiling import span

__all__ = ["QuantizedLinear", "DenseLinear"]

ACTIVATIONS = ("bf16", "int8", "int8_auto", "int8_transient", "int8_xla")


def _golden(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The golden path of a format no kernel takes (dequantize, then a
    float32 matmul; x.dtype out), through its counted plain version."""
    if qt.granularity == "per_group":
        return int4_matmul_per_group_reference(x, qt)
    return int4_matmul_reference(x, qt)


def pg_kernel_format(qt: QuantizedTensor) -> bool:
    """Whether the per-group w4a16 kernels take ``qt``: per_group, planar or
    planar_groups, ``gs % 128 == 0`` dividing K/2 (K6, K7, K12, K13)."""
    return (qt.granularity == "per_group" and qt.layout in ("planar", "planar_groups")
            and qt.group_size % 128 == 0 and (qt.in_dim // 2) % qt.group_size == 0)


def per_group_layout(k: int, granularity: str, group_size: int) -> str:
    """The layout ``from_dense`` packs: planar_groups for per_group weights
    when the batched-partials kernels take them (``gs % 128 == 0`` and
    ``gs | K/2``), else planar."""
    if granularity == "per_group" and group_size % 128 == 0 and (k // 2) % group_size == 0:
        return "planar_groups"
    return "planar"


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

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.weight, self.bias)
                   if t is not None)

    def as_xla_turbo(self) -> "DenseLinear":
        return self  # already a plain dense matmul

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("linear"):
            y = x @ self.weight.t().to(x.dtype)
            if self.bias is not None:
                y = y + self.bias.to(y.dtype)
            return y


class QuantizedLinear(nn.Module):
    """INT4 weight-only linear layer: ``y = x @ dequant(W)^T (+ b)``.

    ``out_features``: the logical output width when the stored rows are
    padded; outputs are sliced back to it. ``activation``: the execution
    mode (module docstring); ``use_kernel=False`` sends every call that is
    not on an integer-GEMM path to the golden path, as in JAX; ``w8``: the
    i8-resident copy of the same weights that ``"int8_xla"`` runs on.
    """

    # Rows at which "int8_auto" leaves the w4a8 kernel for the transient
    # unpack + int8 GEMM (the JAX package's value, a TPU measurement).
    _AUTO_PREFILL_M = 256

    def __init__(
        self,
        weight: QuantizedTensor,
        bias: Optional[torch.Tensor] = None,
        *,
        out_features: Optional[int] = None,
        activation: str = "bf16",
        use_kernel: bool = True,
        w8: Optional[Int8Resident] = None,
    ):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation={activation!r} is not one of {ACTIVATIONS}")
        self.register_buffer("packed", weight.packed)
        self.register_buffer("scales", weight.scales)
        self.register_buffer("zero_points", weight.zero_points)
        self.register_buffer("bias", bias)
        self.register_buffer("w8_q8", None if w8 is None else w8.q8)
        self.register_buffer("w8_scales", None if w8 is None else w8.scales)
        self.shape: Tuple[int, ...] = tuple(weight.shape)
        self.bits = weight.bits
        self.granularity = weight.granularity
        self.layout = weight.layout
        self.block_k = weight.block_k
        self.group_size = weight.group_size
        self.out_features = out_features
        self.activation = activation
        self.use_kernel = use_kernel

    @classmethod
    def from_dense(cls, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                   granularity: str = "per_row", group_size: int = 128, device=None,
                   **kw) -> "QuantizedLinear":
        """Quantize a dense [N, K] weight, per_row or per_group (planar_groups
        where the batched-partials kernels take it, else planar). The layer
        lives on the weight's device, or on ``device`` when one is given
        (None there means the weight's own)."""
        if device is not None:
            device = resolve_device(device)
            weight = weight.to(device)
            bias = None if bias is None else bias.to(device)
        layout = per_group_layout(weight.shape[-1], granularity, group_size)
        return cls(quantize(weight, granularity=granularity, layout=layout,
                            group_size=group_size), bias, **kw)

    @classmethod
    def init(cls, in_dim: int, out_dim: int, *, generator: Optional[torch.Generator] = None,
             device=None, bias: bool = False) -> "QuantizedLinear":
        """Random N(0, 1/in_dim) weight, drawn from ``generator`` on ``device``
        (None: the CUDA card)."""
        device = resolve_device(device)
        w = torch.randn((out_dim, in_dim), generator=generator, device=device,
                        dtype=torch.float32) * (in_dim ** -0.5)
        b = torch.zeros((out_dim,), device=device) if bias else None
        return cls.from_dense(w, b)

    @property
    def weight(self) -> QuantizedTensor:
        return QuantizedTensor(self.packed, self.scales, self.zero_points, self.shape,
                               granularity=self.granularity, layout=self.layout,
                               block_k=self.block_k, group_size=self.group_size,
                               bits=self.bits)

    @property
    def w8(self) -> Optional[Int8Resident]:
        return None if self.w8_q8 is None else Int8Resident(self.w8_q8, self.w8_scales)

    @property
    def in_dim(self) -> int:
        return self.shape[-1]

    @property
    def out_dim(self) -> int:
        return self.out_features or self.shape[-2]

    @property
    def nbytes(self) -> int:
        """Bytes of the packed weight, its scales and zero points, and the bias."""
        bias = 0 if self.bias is None else self.bias.numel() * self.bias.element_size()
        return self.weight.nbytes + bias

    def padded_for_kernel(self) -> "QuantizedLinear":
        """The layer with its weight rows padded once to a multiple of
        ``ops.int8_xla.ROW_MULTIPLE`` (what the integer GEMM takes), so that
        no call pays ``_int_dot``'s per-call pad; padded rows dequantize to
        exact zeros, and outputs are sliced back to ``out_features``.
        per_tensor weights, and rows already at the multiple, return the
        layer as it is."""
        w = self.weight
        if w.granularity not in ("per_row", "per_group"):
            return self
        padded = pad_rows(w, ROW_MULTIPLE)
        if padded is w:
            return self
        return QuantizedLinear(padded, self.bias, out_features=self.out_dim,
                               activation=self.activation, use_kernel=self.use_kernel,
                               w8=self.w8)

    def as_xla_turbo(self) -> "QuantizedLinear":
        """Switch this layer, in place, to the i8-resident mode: attach
        ``w8`` (unless it holds one already) and return the layer. The packed
        weights stay; serving memory grows by the i8 copy (2x packed)."""
        if self.w8_q8 is None:
            w8 = to_int8_resident(self.weight)
            self.w8_q8, self.w8_scales = w8.q8, w8.scales
        self.activation = "int8_xla"
        return self

    def as_u4_turbo(self) -> "QuantizedLinear":
        """Switch this layer, in place, to regime-dispatched w4a8 with packed
        residency (``"int8_auto"``) and return it."""
        self.activation = "int8_auto"
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("linear"):
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        per_row = self.use_kernel and w.granularity == "per_row" and w.layout == "planar"
        activation = self.activation
        if activation == "int8_auto":
            m = x.numel() // x.shape[-1]
            transient = (m >= self._AUTO_PREFILL_M and w.layout == "planar"
                         and w.granularity in ("per_row", "per_tensor"))
            activation = "int8_transient" if transient else "int8"
        if activation == "int8_transient":
            y = int4_linear_transient(x, w)
        elif activation == "int8_xla" and self.w8_q8 is not None:
            y = int8_linear(x, self.w8)
        elif per_row and activation == "int8":
            y = int4_matmul_a8(x, w)
        elif per_row:
            y = int4_matmul(x, w)
        elif (self.use_kernel and activation == "int8" and w.granularity == "per_group"
              and w.layout == "planar_groups"):
            y = int4_matmul_per_group_a8(x, w)
        elif self.use_kernel and pg_kernel_format(w):
            y = int4_matmul_per_group(x, w)   # K7 (planar_groups) or K6 (planar)
        else:
            y = _golden(x, w)                 # no kernel, as in JAX
        if self.out_features and y.shape[-1] != self.out_features:
            y = y[..., : self.out_features]
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def extra_repr(self) -> str:
        return (f"in={self.in_dim}, out={self.out_dim}, bits={self.bits}, "
                f"granularity={self.granularity}, layout={self.layout}, "
                f"bias={self.bias is not None}, activation={self.activation}")
