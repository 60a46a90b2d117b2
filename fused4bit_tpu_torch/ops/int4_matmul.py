"""INT4 weight-only linear, ``x @ dequant(W)^T``, over kernels K1, K4, K5,
K6, K7 and K8.

Counterpart of ``fused4bit_tpu/ops/int4_matmul.py``:

* ``int4_matmul`` (w4a16): on a CUDA tensor it launches K1 through
  ``csrc/int4_matmul.cu`` (the port of the TPU kernel
  ``_int4_matmul_kernel``): bf16 activations run the tensor-core body of
  ``csrc/int4_mma.cuh`` at the launch shape of :func:`_mma_launch`, f32 ones
  the CUDA-core loop of ``csrc/int4_rows.cuh``; on a CPU tensor it runs the
  plain version, :func:`int4_matmul_reference`. Above ``prefill_threshold``
  rows, as in the JAX package, the product is computed outside any kernel:
  dequantize once, then a dense matmul.
* ``int4_matmul_a8`` (w4a8): per-row int8 activations and an exact integer
  dot. On a CUDA tensor it launches K4 (the port of ``_int4_a8_kernel``,
  which takes activations quantized by the host quantizer, a division by
  127, see :func:`~.int8_xla._quantize_acts`) or K5 (the port of
  ``_int4_a8_fused_kernel``, which quantizes with XLA's folded f32(1/127)):
  both the int8 tensor-core body of ``csrc/int8_mma.cuh`` as a one-expert
  stack, K10's arithmetic, at the launch shape of :func:`_row_a8_launch`,
  its first pass quantizing in the kernel's own arithmetic. On a CPU tensor
  it runs :func:`int4_matmul_a8_reference`.
* ``int4_matmul_per_group`` (w4a16, per-group weights), at every row count:
  in the planar_groups layout, on a CUDA tensor it launches
  ``csrc/int4_matmul_pg.cu``, K7 (the port of ``_int4_group_bp_kernel``;
  bf16 at ``gs % 64 == 0`` on the tensor-core body of ``csrc/int4_mma.cuh``
  at the launch shape of :func:`_fold_mma_launch`, from
  :data:`WG_MIN_LINEAR_ROWS` rows the warpgroup body of
  ``csrc/grouped_wgmma.cu`` (:func:`_k7_wg_body`), else the CUDA-core loop
  of ``csrc/int4_rows_pg.cuh``), on a CPU tensor it runs
  :func:`int4_matmul_per_group_reference`; in the
  planar layout (what ``models.convert`` produces), K6 in
  ``csrc/int4_matmul.cu`` (the port of ``_int4_group_kernel``; bf16 on the
  tensor-core body, f32 on the CUDA-core loop), or on a CPU tensor
  :func:`int4_matmul_per_group_planar_reference`.
* ``int4_matmul_per_group_a8`` (w4a8, the same weights): the activations are
  quantized before the main kernel, as the TPU wrapper does, then K8 (the
  port of ``_int4_group_bp_a8_kernel``): at ``gs % 32 == 0`` the int8
  tensor-core body of ``csrc/int8_mma.cuh`` (its first pass quantizes) at
  the launch shape of :func:`_linear_a8_launch`, as a one-expert stack; at
  other group sizes the host quantizer, then the CUDA-core loop of
  ``csrc/int4_rows_pg.cuh``. On a CPU tensor it runs
  :func:`int4_matmul_per_group_a8_reference`.

The int8 body's helpers live here (its launch rules, its launcher and the
plain version of its per-group fold); ``grouped_matmul`` imports them for
K10, K11 and K14.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..quant.core import QuantizedTensor, dequantize, planar_groups_to_planar, unpack_planar
from ..quant.reference import full_precision, reference_linear_qt
from ..utils.profiling import span
from . import _build
from .int8_xla import _quantize_acts

__all__ = [
    "int4_matmul", "int4_matmul_reference", "int4_matmul_a8", "int4_matmul_a8_reference",
    "int4_matmul_per_group", "int4_matmul_per_group_reference",
    "int4_matmul_per_group_planar_reference",
    "int4_matmul_per_group_a8", "int4_matmul_per_group_a8_reference", "quantized_linear",
]

_KERNELS = {torch.bfloat16: "f4b_int4_matmul_bf16", torch.float32: "f4b_int4_matmul_f32"}
_PG_KERNELS = {torch.bfloat16: "f4b_int4_matmul_pg_bf16", torch.float32: "f4b_int4_matmul_pg_f32"}
_PG_MMA_KERNEL = "f4b_int4_matmul_pg_mma_bf16"   # K7 on the tensor-core body
_FOLD_GS = 64     # K7 runs the tensor-core body at group sizes that are multiples of this
_PG_A8_KERNELS = {   # K8 at group sizes the int8 body does not take
    torch.bfloat16: "f4b_int4_matmul_pg_a8_bf16",
    torch.float32: "f4b_int4_matmul_pg_a8_f32",
}
_PLANAR_PG_KERNELS = {
    torch.bfloat16: "f4b_int4_matmul_planar_pg_bf16",
    torch.float32: "f4b_int4_matmul_planar_pg_f32",
}
# The JAX fuse gate (int4_matmul.py:1289-1299), kept as it stands: fuse the
# quantization at K <= 2 * _SHALLOW_KH while the raw-x block and its i8 copy
# fit 4 MiB. On the TPU it weighs quantizing inside the kernel against
# before it; on the card K4 and K5 both quantize in the int8 body's first
# pass, so that trade is gone. It stays JAX's because it picks the
# quantizer's arithmetic (K4 divides by 127, K5 multiplies by f32(1/127)),
# and with it the bits JAX gives.
_SHALLOW_KH = 3072


def int4_matmul_reference(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Plain version of K1: dequantize, then a float32 matmul; x.dtype out.
    Any format: it is also the golden path of the formats no kernel takes
    (per_tensor, the interleaved and block_planar layouts; ``QuantizedLinear``,
    as in JAX)."""
    int4_matmul_reference.calls += 1
    return reference_linear_qt(x, qt, dtype=x.dtype)


int4_matmul_reference.calls = 0


def _check_qt(qt: QuantizedTensor) -> None:
    if qt.granularity != "per_row":
        raise NotImplementedError(
            f"the fused kernel supports per_row scales; got {qt.granularity}"
        )
    if qt.layout != "planar":
        raise ValueError(f"the kernel requires the planar layout; got {qt.layout}")


def _check_operands(x2: torch.Tensor, qt: QuantizedTensor, kernels, what: str) -> None:
    m, k = x2.shape
    n = qt.out_dim
    if x2.dtype not in kernels:
        raise TypeError(f"{what} takes bf16 or f32 activations, got {x2.dtype}")
    if k % 32 != 0:
        raise ValueError(f"{what} needs K % 32 == 0 (16-byte packed rows), got K={k}")
    for name, t, dtype in (
        ("packed", qt.packed, torch.uint8),
        ("scales", qt.scales, torch.float32),
        ("zero_points", qt.zero_points, torch.float32),
    ):
        if t.device != x2.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {x2.device}")
    if tuple(qt.packed.shape) != (n, k // 2):
        raise ValueError(f"packed shape {tuple(qt.packed.shape)} != {(n, k // 2)}")


def _aligned(x2: torch.Tensor) -> torch.Tensor:
    x2 = x2.contiguous()
    return x2.clone() if x2.data_ptr() % 16 else x2  # the kernels read x with 16-byte loads


# --- the tensor-core body (csrc/int4_mma.cuh) of K1 and K6 in bf16 ---

_MMA_TALL_M = 64      # above this many rows of x, the prefill tile (64 rows per CTA)


def _mma_launch(n: int, k: int, sms: int) -> tuple:
    """The decode launch shape ``(ws, kw, splits)`` of ``csrc/int4_mma.cuh``
    for an [N, K] weight on a card of ``sms`` SMs: each warp takes a 16-row
    tile and ``ws`` k steps of 16 columns, a CTA of 8 warps puts ``kw`` of
    them along K (8 / kw row tiles), and ``splits`` CTAs cover K.

    It depends on (N, K, SMs) only, never on M: every row's sum then runs
    in the same order at every M up to :data:`_MMA_TALL_M`, so a row's output
    does not depend on the rows beside it (the self-draft verify at 40 rows
    reproduces the 8-row decode bit for bit).

    ``ws`` is the largest of 32, 16, ..., 1 that still gives every SM a warp
    of work (32 steps: 8 loads of 16 bytes in flight per lane). Where the
    row tiles outnumber the SMs, a CTA takes 8 of them, which share its
    staged x, and K is split across CTAs (``kw`` 1); else a CTA takes one row
    tile with its 8 warps along K (``kw`` 8), so that K is split across CTAs
    only beyond 8 * ws steps, and the second pass that adds the splits
    (1-5 us on the H100, scripts/mma_sweep.py) is spared. A CTA's range is
    whole chunks of 8 steps."""
    return _launch_shape(n, k, sms, (32, 16, 8, 4, 2, 1))


def _fold_mma_launch(n: int, k: int, sms: int) -> tuple:
    """K7's decode launch shape on the tensor-core body: :func:`_mma_launch`'s
    rule with whole chunks of 8 k steps per warp (``ws`` in 32, 16, 8), so
    that each warp folds the partial sums of whole chunks, each of one group
    (gs % 64 == 0). It reads (N, K, SMs) only, as :func:`_mma_launch` does;
    at every layer2 shape the two give the same shape."""
    return _launch_shape(n, k, sms, (32, 16, 8))


def _launch_shape(n: int, k: int, sms: int, widths: tuple) -> tuple:
    tiles = -(-n // 16)
    steps = 8 * -(-(k // 2) // 64)  # 64 packed bytes (8 k steps) per chunk
    for ws in widths:
        if ws <= steps and tiles * -(-steps // ws) >= sms:
            break
    kw = max(1 if tiles > sms else 8, -(-8 // ws))
    return ws, kw, -(-steps // (kw * ws))


def _mma_tall_launch(n: int, k: int, m: int, sms: int) -> tuple:
    """The prefill launch shape ``(ws, 1, splits)`` above :data:`_MMA_TALL_M`
    rows: a CTA takes 8 row tiles and 64 rows of x and walks its range of K
    in stages of 32 k steps; K is split across CTAs only as far as it takes
    to give every SM a CTA (k and v at N=1024, the router at N=8), in whole
    stages."""
    stages = -(-(k // 2) // 256)                      # 32 k steps (256 packed bytes) each
    ctas = -(-n // 128) * -(-m // 64)
    ws = 32 * -(-stages // min(stages, -(-sms // ctas)))
    return ws, 1, -(-32 * stages // ws)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_mma(x2: torch.Tensor, qt: QuantizedTensor, kernel: str, what: str,
                *gs: int, decode=_mma_launch) -> torch.Tensor:
    """Launch the bf16 tensor-core body (K1, or K6/K7 with their group size
    ``gs``): the decode shape of ``decode`` (:func:`_mma_launch`, K7's
    :func:`_fold_mma_launch`) with 16 rows of x per CTA at M <= 64, above it
    :func:`_mma_tall_launch` with 64."""
    m, k = x2.shape
    n = qt.out_dim
    sms = _sm_count(x2.device.index)
    if m > _MMA_TALL_M:
        (ws, kw, splits), mt = _mma_tall_launch(n, k, m, sms), 64
    else:
        (ws, kw, splits), mt = decode(n, k, sms), 16
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x2.device)
               if splits > 1 else None)
    with torch.cuda.device(x2.device):
        err = getattr(_build.library(), kernel)(
            x2.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(), qt.zero_points.data_ptr(),
            y.data_ptr(), None if partial is None else partial.data_ptr(), m, n, k, *gs,
            ws, kw, splits, mt, _build.stream_of(x2),
        )
    _build.check(err, what)
    return y


def _launch(x2: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    _check_operands(x2, qt, _KERNELS, "K1")
    m, k = x2.shape
    n = qt.out_dim
    if x2.dtype == torch.bfloat16:
        y = _launch_mma(x2, qt, _KERNELS[x2.dtype], "int4_matmul")
    else:
        y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
        with torch.cuda.device(x2.device):
            err = getattr(_build.library(), _KERNELS[x2.dtype])(
                x2.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(),
                qt.zero_points.data_ptr(), y.data_ptr(), m, n, k, _build.stream_of(x2),
            )
        _build.check(err, "int4_matmul")
    int4_matmul.launches += 1
    return y


# K1's row threshold, measured on the H100 (scripts/linear_sweep.py): at the
# `layer2` shapes the kernel beats dequantize + matmul at every M up to 512,
# and the dense path first wins at 640 rows (k and v, N=1024).
PREFILL_THRESHOLD = 512


def int4_matmul(
    x: torch.Tensor, qt: QuantizedTensor, *, prefill_threshold: int = PREFILL_THRESHOLD
) -> torch.Tensor:
    """``x @ dequant(qt)^T`` without materializing the dense weight.

    x: [..., K] (bf16 or f32); qt: per_row planar [N, K]. Returns [..., N]
    in x.dtype. Rows above ``prefill_threshold`` dequantize once and run a
    dense matmul in x.dtype with float32 accumulation.
    """
    _check_qt(qt)
    n, k = qt.out_dim, qt.in_dim
    if x.shape[-1] != k:
        raise ValueError(f"x.shape[-1]={x.shape[-1]} != K={k}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if m > prefill_threshold:
        with span("linear.dense"):
            wd = dequantize(qt, dtype=x.dtype)
            return torch.matmul(x2, wd.t()).reshape(*lead, n)
    if not x.is_cuda:
        return int4_matmul_reference(x2, qt).reshape(*lead, n)
    if m == 0:
        return x.new_empty((*lead, n))
    return _launch(_aligned(x2), qt).reshape(*lead, n)


int4_matmul.launches = 0


def quantized_linear(x: torch.Tensor, qt: QuantizedTensor, **kw) -> torch.Tensor:
    """:func:`int4_matmul` under the reference library's forward name."""
    return int4_matmul(x, qt, **kw)


def _a8_product(xq: torch.Tensor, sx: torch.Tensor, packed: torch.Tensor,
               scales: torch.Tensor, zero_points: torch.Tensor) -> torch.Tensor:
    """The w4a8 product in plain torch, f32 out: ``(s * sx) * (f32(xq . q) -
    zp * f32(sum(xq)))`` with q the 4-bit codes of the planar bytes.

    The dot runs in float64, which is exact here (every sum stays far below
    2^53), and equals the TPU kernel's int32 ``acc + 8 * xsum_hi``; the f32
    epilogue is JAX's, operation by operation."""
    q = unpack_planar(packed).double()                       # [N, K] codes 0..15
    acc = xq.double() @ q.t()
    xsum = xq.double().sum(dim=-1, keepdim=True)
    yq = acc.float() - zero_points.float()[None, :] * xsum.float()
    return scales.float()[None, :] * sx * yq


def int4_matmul_a8_reference(
    x: torch.Tensor, qt: QuantizedTensor, *, fuse_quant: bool = False
) -> torch.Tensor:
    """Plain version of K4 and K5: quantize (with K5's quantizer when
    ``fuse_quant``, see :func:`~.int8_xla._quantize_acts`), exact dot, JAX's
    epilogue; x.dtype out."""
    int4_matmul_a8_reference.calls += 1
    xq, sx = _quantize_acts(x, fused=fuse_quant)
    return _a8_product(xq, sx, qt.packed, qt.scales, qt.zero_points).to(x.dtype)


int4_matmul_a8_reference.calls = 0


def int4_matmul_a8(
    x: torch.Tensor, qt: QuantizedTensor, *, fuse_quant: Optional[bool] = None
) -> torch.Tensor:
    """w4a8 linear: per-row int8 activations, exact integer dot.

    x: [..., K] (bf16 or f32); qt: per_row planar [N, K]. Returns [..., N] in
    x.dtype, at every row count (no dequantize fallback, as in JAX).
    ``fuse_quant``: quantize as the TPU kernel that quantizes inside itself
    does (K5: XLA's folded multiply by f32(1/127)) rather than as the host
    quantizer (K4: a division by 127); None applies the JAX gate. On the
    card both run the int8 body's first pass in that arithmetic, then its
    main kernel. On a CPU tensor the plain version runs with the quantizer
    of the kernel that ``fuse_quant`` picks.
    """
    _check_qt(qt)
    n, k = qt.out_dim, qt.in_dim
    if x.shape[-1] != k:
        raise ValueError(f"x.shape[-1]={x.shape[-1]} != K={k}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if fuse_quant is None:
        tile_m = min(-(-max(m, 1) // 32) * 32, 256)
        fuse_quant = (k <= 2 * _SHALLOW_KH
                      and tile_m * k * (x.element_size() + 1) <= 4 * 1024 * 1024)
    if not x.is_cuda:
        return int4_matmul_a8_reference(x2, qt, fuse_quant=fuse_quant).reshape(*lead, n)
    if m == 0:
        return x.new_empty((*lead, n))
    x2 = _aligned(x2)
    _check_operands(x2, qt, _A8_PREPASS, "K5" if fuse_quant else "K4")
    y = _launch_a8_mma(x2, None, qt, 0, *_row_a8_launch(n, k, m, _sm_count(x2.device.index)),
                       fused=fuse_quant)
    if fuse_quant:
        int4_matmul_a8.fused_launches += 1
    else:
        int4_matmul_a8.launches += 1
    return y.reshape(*lead, n)


int4_matmul_a8.launches = 0        # K4
int4_matmul_a8.fused_launches = 0  # K5


# --- per-group weights: K7 (w4a16) and K8 (w4a8) on planar_groups, K6 on planar ---


def _check_per_group(qt: QuantizedTensor, *, a8: bool = False) -> None:
    """The format checks of the per-group wrappers (K6/K7, K8, K12/K13, K14),
    made before the CPU/CUDA split so both devices accept the same weights.

    The w4a16 wrappers read per_group weights in the planar_groups layout
    with ``gs % 16 == 0`` dividing K/2 (the batched-partials kernels' 16-byte
    runs never cross a group), and in the planar layout with
    ``gs % 128 == 0`` dividing K/2 (the TPU's scale-expansion kernels K6 and
    K12; any other planar group size raises ValueError, as in JAX). The w4a8
    wrappers (``a8``) take planar_groups only, as in JAX, and hold the
    exactness bound ``127 * 128 * gs < 2**24`` (the TPU kernels' int32 -> f32
    cast)."""
    gs, kh = qt.group_size, qt.in_dim // 2
    layouts = ("planar_groups",) if a8 else ("planar", "planar_groups")
    if qt.granularity != "per_group" or qt.layout not in layouts:
        raise ValueError(f"requires per_group + {'/'.join(layouts)} weights")
    if qt.layout == "planar":
        if gs % 128 != 0 or kh % gs != 0:
            raise ValueError(f"group_size={gs} must be a multiple of 128 dividing K/2={kh}")
        return
    if gs % 16 != 0 or kh % gs != 0:
        raise ValueError(f"group_size={gs} must be a multiple of 16 dividing K/2={kh}")
    if a8 and 127 * 128 * gs >= 1 << 24:
        raise ValueError(
            f"group_size={gs}: the w4a8 per-group partials (up to 127*128*gs) "
            "are not exact in f32 at or above 2**24"
        )


def _check_pg_operands(x2: torch.Tensor, qt: QuantizedTensor, what: str) -> None:
    """Device, type and shape checks of the per-group kernels' operands:
    packed [..., Gh, N, gs] (planar_groups) or [..., N, K/2] (planar), scales
    and zero points [..., N, K/gs]."""
    gs, n, kh, lead = qt.group_size, qt.out_dim, qt.in_dim // 2, qt.shape[:-2]
    want = (*lead, kh // gs, n, gs) if qt.layout == "planar_groups" else (*lead, n, kh)
    if tuple(qt.packed.shape) != want:
        raise ValueError(f"{what}: packed shape {tuple(qt.packed.shape)} != {want}")
    for name, t, dtype in (
        ("packed", qt.packed, torch.uint8),
        ("scales", qt.scales, torch.float32),
        ("zero_points", qt.zero_points, torch.float32),
    ):
        if t.device != x2.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {x2.device}")
        if name != "packed" and tuple(t.shape) != (*lead, n, 2 * kh // gs):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != {(*lead, n, 2 * kh // gs)}")


def int4_matmul_per_group_reference(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Plain version of K7: dequantize, then a float32 matmul; x.dtype out.
    Any per_group weight: it is also the golden path of the per-group group
    sizes no kernel serves (``QuantizedLinear``, as in JAX)."""
    int4_matmul_per_group_reference.calls += 1
    return reference_linear_qt(x, qt, dtype=x.dtype)


int4_matmul_per_group_reference.calls = 0


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The TPU kernels' compute type: f32 for f32 activations, else bf16."""
    return torch.float32 if x.dtype == torch.float32 else torch.bfloat16


def planar_pg_weight(packed: torch.Tensor, scales: torch.Tensor, zero_points: torch.Tensor,
                     group_size: int, dtype: torch.dtype) -> torch.Tensor:
    """The planar per-group weight [..., N, K] as K6 and K12 dequantize it,
    held in f32: ``dtype(dtype(s) * (q - zp))``, the scale rounded to the
    compute type ``dtype``, then the product (exact in f32 for a bf16 scale)
    rounded to it. In bf16 that is two roundings, which is not
    :func:`~..quant.core.dequantize` (one f32 rounding)."""
    q = unpack_planar(packed).float()                                  # [..., N, K]
    qg = q.reshape(*q.shape[:-1], q.shape[-1] // group_size, group_size)
    s = scales.to(dtype).float()[..., None]
    w = (s * (qg - zero_points.float()[..., None])).to(dtype).float()
    return w.reshape(q.shape)


def int4_matmul_per_group_planar_reference(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Plain version of K6: the weight dequantized to the compute type as the
    TPU kernel does (:func:`planar_pg_weight`), then a float32 matmul;
    x.dtype out."""
    int4_matmul_per_group_planar_reference.calls += 1
    w = planar_pg_weight(qt.packed, qt.scales, qt.zero_points, qt.group_size, _compute_dtype(x))
    with full_precision():
        y = torch.matmul(x.float(), w.transpose(-1, -2))
    return y.to(x.dtype)


int4_matmul_per_group_planar_reference.calls = 0


def _k7_on_tensor_cores(dtype: torch.dtype, group_size: int) -> bool:
    """K7's body (and K13's, its grouped twin), chosen by the operands'
    format alone: the tensor-core body (``csrc/int4_mma.cuh``, GroupFold) for
    bf16 x at ``gs % 64 == 0`` (a 64-byte chunk never straddles two groups),
    else the CUDA-core loop of ``csrc/int4_rows_pg.cuh`` (f32 x, as for
    K1/K6; and the other group sizes planar_groups allows)."""
    return dtype == torch.bfloat16 and group_size % _FOLD_GS == 0


# K7's tall calls on the warpgroup body (csrc/grouped_wgmma.cu, its GroupFold
# instance without grouped addressing). The body's output features per work
# item, K7's rows of x per item and packed bytes per chunk of K/2 (kWgSlice,
# WgShape<GroupFold>::kRows, kChunkBytes; grouped_matmul's K2 and K13 share
# the slice and the chunk).
_PG_WG_KERNEL = "f4b_int4_matmul_pg_wg_bf16"
_WG_SLICE = 128
_WG_ROWS = 128
_WG_CHUNK = 64
_WG_MAX_SPLITS = 8
# Rows of x from which a bf16 K7 call runs the warpgroup body, measured:
# scripts/linear_sweep.py --pg on an H100 80GB HBM3 at 700 W times the body
# against the tall tile at 65, 72, 80, 96, 128, ... rows, and the body wins
# at every per-group cell's linear from the first of them (1.3-2.5x at 65;
# PERF.md section 6 has the readings). Below 65 K7 keeps its decode tile.
WG_MIN_LINEAR_ROWS = 65
# The split rule's model of the body, fitted to the same sweep's launch
# timings (``launch_ms``: the body at 896 and 384 rows under each candidate
# launch; PERF.md section 6): a CTA's microseconds per chunk of an item (the
# whole-item launches read 1.87-1.94 at 896 rows), per item (ring fill and
# epilogue: what a launch of more, shorter items adds), and per f32 partial
# element of the second pass (written, then read back, at ~3 TB/s of
# HBM). tests/test_torch_pg_linear_wg.py pins the rule's pick at each cell
# shape to the fastest launch that sweep read there.
_WG_CHUNK_US = 1.9
_WG_ITEM_US = 3.0
_WG_PARTIAL_US = 8 / 3.0e6


def _k7_wg_body(dtype: torch.dtype, group_size: int, m: int, n: int, k: int) -> bool:
    """Whether a K7 call (planar_groups, per group of ``group_size``) runs the
    warpgroup body rather than :func:`_launch_mma`'s tall tile: bf16 x at
    ``gs % 64 == 0`` (:func:`_k7_on_tensor_cores`), N in whole slices of
    128, K/2 in whole chunks of 64 bytes, and at least
    :data:`WG_MIN_LINEAR_ROWS` rows (above :data:`_MMA_TALL_M`: never at
    decode or the verify, whose 64-row tile K7 keeps). It reads the call's
    type and shape only."""
    return (_k7_on_tensor_cores(dtype, group_size) and m >= WG_MIN_LINEAR_ROWS
            and n % _WG_SLICE == 0 and (k // 2) % _WG_CHUNK == 0)


@functools.lru_cache(maxsize=None)
def _wg_linear_launch(m: int, n: int, k: int, sms: int) -> tuple:
    """K7's launch ``(full, splits, grid)`` on the warpgroup body for M rows of
    x and an [N, K] weight on a card of ``sms`` SMs. Its items are (slice of
    128 features, block of 128 rows): the first ``full`` (whole slices) take
    all of K/2 and write y; each slice after them is cut into ``splits``
    ranges of whole chunks (none empty), whose f32 partials the second pass
    adds in order. ``grid`` persistent CTAs take the items in turn.

    Whole items alone leave a ragged last wave where their count is no
    multiple of the SMs (Mixtral-8x22B's q and o at 384 rows: 144 items on
    132 SMs), or fall short of the card (K-EXAONE's k and v at 896 rows: 56).
    The rule times each candidate by walking its items over the CTAs as the
    kernel does, a CTA's time per item that of its chunks plus a fixed cost,
    the partials' traffic added: all items whole, or for each ``splits`` in
    2 .. :data:`_WG_MAX_SPLITS` no whole item or as many whole slices as fill
    whole waves; the least time wins, ties to the earlier. It reads (M, N,
    K, SMs) only."""
    slices, blocks = n // _WG_SLICE, -(-m // _WG_ROWS)
    items = slices * blocks
    chunks = (k // 2) // _WG_CHUNK
    waved = (items // sms * sms) // blocks * blocks          # whole slices in whole waves
    candidates = [(items, 1)] + [(full, s) for s in range(2, min(_WG_MAX_SPLITS, chunks) + 1)
                                 for full in dict.fromkeys((0, waved))
                                 if full < items and (s - 1) * -(-chunks // s) < chunks]
    best = None
    for full, s in candidates:
        span = -(-chunks // s)
        z = torch.arange((items - full) * s, dtype=torch.float64) // blocks % s  # a piece's range
        costs = torch.cat([torch.full((full,), float(chunks), dtype=torch.float64),
                           torch.clamp(chunks - z * span, max=span)]) * _WG_CHUNK_US
        grid = min(len(costs), sms)
        costs = torch.nn.functional.pad(costs + _WG_ITEM_US, (0, -len(costs) % grid))
        t = (costs.reshape(-1, grid).sum(0).max().item()
             + (full < items) * s * m * (n - full // blocks * _WG_SLICE) * _WG_PARTIAL_US)
        if best is None or t < best[0]:
            best = (t, full, s, grid)
    return best[1:]


def _launch_pg_wg(x2: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """K7 on the warpgroup body at :func:`_wg_linear_launch`'s launch: the
    persistent main kernel, then where slices are cut into ranges the
    ordered second pass. Operands checked, x 16-byte aligned."""
    m, k = x2.shape
    n = qt.out_dim
    if qt.packed.data_ptr() % 16:
        raise ValueError("the warpgroup body needs 16-byte aligned packed weights")
    full, splits, grid = _wg_linear_launch(m, n, k, _sm_count(x2.device.index))
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    tail = n - full // -(-m // _WG_ROWS) * _WG_SLICE            # features cut into ranges
    partial = (torch.empty((splits, m, tail), dtype=torch.float32, device=x2.device)
               if tail else None)
    with torch.cuda.device(x2.device):
        err = getattr(_build.library(), _PG_WG_KERNEL)(
            x2.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(), qt.zero_points.data_ptr(),
            y.data_ptr(), None if partial is None else partial.data_ptr(), m, n, k,
            qt.group_size, full, splits, grid, _build.stream_of(x2))
    _build.check(err, "int4_matmul_per_group")
    return y


def int4_matmul_per_group(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``x @ dequant(qt)^T`` for per-group weights, at every row count (the
    JAX per-group linear has no dequantize fallback).

    x: [..., K] (bf16 or f32); qt: per_group [N, K], planar_groups (K7) or
    planar with ``gs % 128 == 0`` (K6). Returns [..., N] in x.dtype.
    """
    _check_per_group(qt)
    planar = qt.layout == "planar"
    n, k = qt.out_dim, qt.in_dim
    if x.shape[-1] != k:
        raise ValueError(f"x.shape[-1]={x.shape[-1]} != K={k}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if not x.is_cuda:
        plain = (int4_matmul_per_group_planar_reference if planar
                 else int4_matmul_per_group_reference)
        return plain(x2, qt).reshape(*lead, n)
    what = "K6" if planar else "K7"
    kernels = _PLANAR_PG_KERNELS if planar else _PG_KERNELS
    if x2.dtype not in kernels:
        raise TypeError(f"{what} takes bf16 or f32 activations, got {x2.dtype}")
    if k % 32 != 0:
        raise ValueError(f"{what} needs K % 32 == 0 (16-byte packed rows), got K={k}")
    _check_pg_operands(x2, qt, what)
    m = x2.shape[0]
    if m == 0:
        return x.new_empty((*lead, n))
    return _launch_per_group(_aligned(x2), qt).reshape(*lead, n)


def _launch_per_group(x2: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """K6 or K7 on the body the operands choose, and its launch counted.
    Operands checked, x 16-byte aligned, M > 0."""
    planar = qt.layout == "planar"
    kernels = _PLANAR_PG_KERNELS if planar else _PG_KERNELS
    m, k = x2.shape
    n = qt.out_dim
    wg = not planar and _k7_wg_body(x2.dtype, qt.group_size, m, n, k)
    if wg:
        y = _launch_pg_wg(x2, qt)
    elif planar and x2.dtype == torch.bfloat16:
        y = _launch_mma(x2, qt, kernels[x2.dtype], "int4_matmul_per_group", qt.group_size)
    elif _k7_on_tensor_cores(x2.dtype, qt.group_size):
        y = _launch_mma(x2, qt, _PG_MMA_KERNEL, "int4_matmul_per_group", qt.group_size,
                        decode=_fold_mma_launch)
    else:
        y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
        with torch.cuda.device(x2.device):
            err = getattr(_build.library(), kernels[x2.dtype])(
                x2.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(),
                qt.zero_points.data_ptr(), y.data_ptr(), m, n, k, qt.group_size,
                _build.stream_of(x2),
            )
        _build.check(err, "int4_matmul_per_group")
    if planar:
        int4_matmul_per_group.planar_launches += 1
    else:
        int4_matmul_per_group.launches += 1
        int4_matmul_per_group.wg_launches += wg
    return y


int4_matmul_per_group.launches = 0         # K7
int4_matmul_per_group.planar_launches = 0  # K6
int4_matmul_per_group.wg_launches = 0      # of K7's, on the warpgroup body

_LANES = 32   # lanes of a warp, each over its own runs of 16 packed bytes
_RUN = 16


def _pg_a8_product(xq: torch.Tensor, sx: torch.Tensor, packed3: torch.Tensor,
                   scales: torch.Tensor, zero_points: torch.Tensor) -> torch.Tensor:
    """The w4a8 per-group product in plain torch, f32 out, operation by
    operation as K8 and K14 at gs % 32 != 0 compute it
    (``csrc/int4_rows_pg.cuh``).

    xq [M, K] i8, sx [M, 1] f32, packed3 [Gh, N, gs] u8, scales/zero_points
    [N, 2Gh]. For each run of 16 packed bytes (one lane's load) the exact
    integers P_lo = xq_lo . q_lo, X_lo = sum xq_lo, P_hi = xq_hi . vhi and
    X_hi; each lane folds its runs in chunk order into an f32 sum,
    ``acc += a_lo*P_lo; acc += c_lo*X_lo; acc += a_hi*P_hi; acc += c_hi*X_hi``
    with a = (s_lo, s_hi/16), c = (-s_lo*zp_lo, s_hi*(8 - zp_hi)); the 32
    lane sums meet in the warp's xor butterfly; y = acc * sx. The integer dots
    run as float32 matmuls in full precision, exact since every partial sum
    is an integer below 2^24."""
    m, k = xq.shape
    gh, n, gs = packed3.shape
    kh = gh * gs
    runs = kh // _RUN
    chunks = -(-runs // _LANES)
    pad = chunks * _LANES - runs
    codes = unpack_planar(planar_groups_to_planar(packed3)).float()          # [N, K]
    q_lo = codes[:, :kh].reshape(n, runs, _RUN).transpose(0, 1)              # [runs, N, 16]
    q_hi = codes[:, kh:].reshape(n, runs, _RUN).transpose(0, 1)
    group = torch.arange(runs, device=xq.device) * _RUN // gs                # group of each run
    s, z = scales.float(), zero_points.float()
    s_lo, z_lo = s[:, group].t(), z[:, group].t()                            # [runs, N]
    s_hi, z_hi = s[:, gh + group].t(), z[:, gh + group].t()
    fold = [s_lo, (-s_lo) * z_lo, s_hi * 0.0625, s_hi * (8.0 - z_hi)]        # a_lo, c_lo, a_hi, c_hi
    fold = [torch.nn.functional.pad(f, (0, 0, 0, pad)).reshape(chunks, _LANES, n) for f in fold]
    lanes = torch.arange(_LANES, device=xq.device)
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    for m0 in range(0, m, 16):  # 16 rows at a time bound the [rows, runs, N] partials
        xb = xq[m0:m0 + 16].float()
        rows = xb.shape[0]
        x_lo = xb[:, :kh].reshape(rows, runs, _RUN).transpose(0, 1)          # [runs, rows, 16]
        x_hi = xb[:, kh:].reshape(rows, runs, _RUN).transpose(0, 1)
        with full_precision():
            p_lo = torch.bmm(x_lo, q_lo.transpose(1, 2))                     # [runs, rows, N]
            qh = torch.bmm(x_hi, q_hi.transpose(1, 2))
        xs_lo = x_lo.sum(-1, keepdim=True).expand(-1, -1, n)                 # exact integers
        xs_hi = x_hi.sum(-1, keepdim=True)
        p_hi = 16.0 * (qh - 8.0 * xs_hi)
        xs_hi = xs_hi.expand(-1, -1, n)
        terms = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)).reshape(chunks, _LANES, rows, n)
                 for t in (p_lo, xs_lo, p_hi, xs_hi)]
        acc = torch.zeros((_LANES, rows, n), dtype=torch.float32, device=xq.device)
        for c in range(chunks):
            for f, t in zip(fold, terms):
                acc = acc + f[c][:, None, :] * t[c]
        for off in (16, 8, 4, 2, 1):  # the warp's xor butterfly
            acc = acc + acc[lanes ^ off]
        out[m0:m0 + rows] = acc[0] * sx[m0:m0 + 16].float()
    return out


# --- the int8 tensor-core body (csrc/int8_mma.cuh): K8 here, K10 and K14 in grouped_matmul ---

# the body's first pass (quantize, per-group sums, rows in use)
_A8_PREPASS = {torch.bfloat16: "f4b_a8_prepass_bf16", torch.float32: "f4b_a8_prepass_f32"}
_I8_WARPS = 8        # warps per CTA of the int8 body
# SM count the plain versions of K8 and K14 assume for CPU tensors: the
# H100's (the launch rule, and so their order of f32 sums, depends on it)
_PLAIN_SMS = 132


def _pg_a8_on_tensor_cores(group_size: int) -> bool:
    """K8's and K14's body, chosen by the group size alone: the int8
    tensor-core body at ``gs % 32 == 0`` (a chunk of 32 or 64 packed bytes
    never straddles a group), else the CUDA-core loop of
    ``csrc/int4_rows_pg.cuh`` (the other multiples of 16 that planar_groups
    allows)."""
    return group_size % 32 == 0


def _i8_chunk(gs: int) -> int:
    """Packed bytes per chunk of a row in the int8 body: 4 lanes x 16 bytes,
    or x 8 for K8 and K14 at ``gs % 64 != 0``. ``gs`` 0 means per row (K10)."""
    return 64 if gs % 64 == 0 else 32


def _a8_mma_launch(n: int, k: int, gs: int, sms: int) -> tuple:
    """The launch shape ``(ws, kw, splits)`` of ``csrc/int8_mma.cuh`` for
    K10 and K14 on an [N, K] expert weight (``gs`` its group size, 0 per
    row) on a card of ``sms`` SMs: each warp takes a 16-row tile of output
    rows and a slice of ``ws`` chunks of K/2 (whole groups for K14), a CTA of
    8 warps puts ``kw`` of them along K (8 / kw row tiles), and ``splits``
    CTAs cover K.

    K is cut into the fewest slices that give every SM two warps from one
    block of 16 rows alone (a decode step where one expert is hit): the
    slices go to warps of a CTA first (up to 8, added through shared
    memory), then to CTAs along K (added by a second pass). At the layer2
    shapes that is one slice at gate/up (N=14336: ws 32, kw 1) and two at
    down (N=4096: ws 56, kw 2), splits 1; more slices measured no faster
    there at decode and slower at prefill on the H100
    (``scripts/grouped_a8_sweep.py`` times the candidates; PERF.md).

    It reads (N, K, gs, SMs) only, never T, tile_m or the routing: K14's f32
    sums then run in the same order for a token row wherever it sits, so
    its output bits do not depend on the tile or the T of the dispatch."""
    cb = _i8_chunk(gs)
    unit = gs // cb if gs else 1                      # chunks per group
    units = -(-(k // 2) // (cb * unit))               # groups (K10: chunks)
    tiles = -(-n // 16)
    slices = max(1, min(units, -(-2 * sms // tiles)))
    kw = min(_I8_WARPS, 1 << (slices - 1).bit_length())
    ws = unit * -(-units // (kw * -(-slices // kw)))
    return ws, kw, -(-units * unit // (kw * ws))


def _linear_a8_launch(n: int, k: int, gs: int, sms: int) -> tuple:
    """K8's launch shape ``(ws, kw, 1)`` on the int8 body (see
    :func:`_a8_mma_launch`) for an [N, K] weight per group of ``gs`` (gs %
    32 == 0; 0 per row, K5's decode shape, where one 64-byte chunk stands in
    for a group) on a card of ``sms`` SMs: the fewest warps along K, a power
    of two up to 8 and up to K/2's groups, that give every SM a CTA of 8 warps
    from one block of 16 rows (a decode step), each warp on whole groups; K
    is never split across CTAs. At the layer2 linears that is (4, 8, 1) at
    q/o (N=4096) and k/v (1024), (8, 4, 1) at the lm_head (8192): at 8 rows
    they measured 0.0170, 0.0155 and 0.0222 ms on the H100 against 0.0235,
    0.0155 and 0.0362 at :func:`_a8_mma_launch`'s shapes, which keep two
    warps per SM, and 15-18 % slower at 640 rows
    (``scripts/linear_a8_sweep.py --sweep``; PERF.md).

    It reads (N, K, gs, SMs) only, never M: a row's f32 sums run in the same
    order at every M, so its output bits do not depend on the rows beside it
    (the self-draft verify at 40 rows reproduces the 8-row decode)."""
    cb = _i8_chunk(gs)
    unit = gs // cb if gs else 1                      # chunks per group
    groups = -(-(k // 2) // (cb * unit))
    tiles = -(-n // 16)
    kw = 1
    while kw < _I8_WARPS and kw < groups and tiles * kw < _I8_WARPS * sms:
        kw *= 2
    return unit * -(-groups // kw), kw, 1


def _row_a8_launch(n: int, k: int, m: int, sms: int) -> tuple:
    """K5's and K4's launch shape ``(ws, kw, splits)`` on the int8 body for
    an [N, K] per-row weight and M rows of x on a card of ``sms`` SMs: K8's
    decode rule :func:`_linear_a8_launch` (per row, one CTA of 8 warps per SM
    from one block of 16 rows, no split) up to :data:`_MMA_TALL_M` rows, the
    grouped rule :func:`_a8_mma_launch` (two warps per SM from one block of
    rows) above it, where K8's decode shape measured 15-18 % slower at 640
    rows.

    Unlike the other launch rules it reads M. That is safe because K5's and
    K4's sums are exact int32 (as K10's): their output bits are the same at
    every launch shape, so a row's bits do not depend on the rows beside
    it."""
    if m > _MMA_TALL_M:
        return _a8_mma_launch(n, k, 0, sms)
    return _linear_a8_launch(n, k, 0, sms)


def _launch_a8_mma(x: torch.Tensor, tile_group_ids: Optional[torch.Tensor], qt: QuantizedTensor,
                   tile_m: int, ws: int, kw: int, splits: int, *, fused: bool) -> torch.Tensor:
    """The int8 body at launch shape ``(ws, kw, splits)``: its first pass
    (quantize, per-group sums, which rows hold a nonzero), the main kernel
    and, with splits > 1, the ordered second pass. K10 and K11 for a per_row
    stack, K14 for a per_group one, K4/K5 and K8 for a per_row and a
    per_group linear (``tile_group_ids`` None: one expert, any M). The first
    pass's quantizer: ``fused``, XLA's multiply by f32(1/127) (K5, K11, K14,
    K8), else the host quantizer's division by 127 (K10, K4); see
    :func:`~.int8_xla._quantize_acts`. x 16-byte aligned, operands checked."""
    n, k = qt.shape[-2:]
    m = x.shape[0]
    per_group = qt.granularity == "per_group"
    gs = qt.group_size if per_group else 0
    gsum = gs or k // 2
    dev = x.device
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return y
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    sums = torch.empty((m, k // gsum), dtype=torch.int32, device=dev)
    used = torch.empty((m,), dtype=torch.int32, device=dev)
    partial = (torch.empty((splits, m, n), dtype=torch.float32 if per_group else torch.int32,
                           device=dev) if splits > 1 else None)
    lib = _build.library()
    stream = _build.stream_of(x)
    what = (("int4_matmul" if tile_group_ids is None else "grouped_int4_matmul")
            + ("_per_group_a8" if per_group else "_a8"))
    with torch.cuda.device(dev):
        err = getattr(lib, _A8_PREPASS[x.dtype])(
            x.data_ptr(), xq.data_ptr(), sx.data_ptr(), sums.data_ptr(), used.data_ptr(),
            m, k, gsum, int(fused), stream)
        _build.check(err, f"{what}: the int8 body's first pass")
        ptrs = (xq.data_ptr(), sx.data_ptr(), sums.data_ptr(), used.data_ptr(),
                None if tile_group_ids is None else tile_group_ids.data_ptr(),
                qt.packed.data_ptr(), qt.scales.data_ptr(), qt.zero_points.data_ptr(),
                y.data_ptr(), None if partial is None else partial.data_ptr())
        tail = (tile_m, int(x.dtype == torch.float32), ws, kw, splits, stream)
        if per_group:
            err = lib.f4b_grouped_int4_matmul_pg_a8_mma(*ptrs, m, n, k, gs, *tail)
        else:
            err = lib.f4b_grouped_int4_matmul_a8_mma(*ptrs, m, n, k, *tail)
    _build.check(err, what)
    return y


def _pg_a8_fold_product(xq: torch.Tensor, sx: torch.Tensor, packed3: torch.Tensor,
                        scales: torch.Tensor, zero_points: torch.Tensor, *,
                        launch: tuple) -> torch.Tensor:
    """The w4a8 per-group product in plain torch, f32 out, operation by
    operation as K8 and K14 compute it on the int8 body at launch shape
    ``launch`` = ``(ws, kw, splits)`` (see :func:`_a8_mma_launch`).

    xq [M, K] i8, sx [M, 1] f32, packed3 [Gh, N, gs] u8 (gs % 32 == 0),
    scales/zero_points [N, 2Gh]. Per group g the exact integers P_lo = xq_lo .
    q_lo, P_hi = xq_hi . 16 (q_hi - 8) and the sums X_lo, X_hi of xq over the
    group's columns; K/2 is cut into kw * splits slices of ws chunks (whole
    groups), slice i = z * kw + w. Each slice folds its groups in order into
    an f32 sum from 0: ``acc += s_lo*P_lo; acc += c_lo*X_lo; acc +=
    (s_hi/16)*P_hi; acc += c_hi*X_hi`` with c_lo = -s_lo*zp_lo, c_hi =
    s_hi*(8 - zp_hi); the kw slices of split z are added in order w = 0, 1,
    ..., then the splits in order z = 0, 1, ...; y = acc * sx. The integer
    products run in float64, exact here (every sum is an integer below
    2^24)."""
    ws, kw, splits = launch
    m, k = xq.shape
    gh, n, gs = packed3.shape
    kh = gh * gs
    cpg = gs // _i8_chunk(gs)
    if ws % cpg or ws * kw * splits * _i8_chunk(gs) < kh:
        raise ValueError(f"launch {launch} does not cut K/2={kh} into whole groups of {gs}")
    codes = unpack_planar(planar_groups_to_planar(packed3)).double()         # [N, K]
    q_lo = codes[:, :kh].reshape(n, gh, gs)
    v_hi = 16.0 * (codes[:, kh:].reshape(n, gh, gs) - 8.0)
    s, z = scales.float(), zero_points.float()
    fold = (s[:, :gh], (-s[:, :gh]) * z[:, :gh], s[:, gh:] * 0.0625,
            s[:, gh:] * (8.0 - z[:, gh:]))                                    # [N, Gh] each
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    for m0 in range(0, m, 64):  # 64 rows at a time bound the [Gh, rows, N] products
        xb = xq[m0:m0 + 64].double()
        rows = xb.shape[0]
        x_lo = xb[:, :kh].reshape(rows, gh, gs)
        x_hi = xb[:, kh:].reshape(rows, gh, gs)
        p_lo = torch.einsum("rgc,ngc->grn", x_lo, q_lo).float()
        p_hi = torch.einsum("rgc,ngc->grn", x_hi, v_hi).float()
        xs_lo, xs_hi = x_lo.sum(-1).float(), x_hi.sum(-1).float()             # [rows, Gh]
        parts = [torch.zeros((rows, n), dtype=torch.float32, device=xq.device)
                 for _ in range(kw * splits)]
        for g in range(gh):
            i = g * cpg // ws
            a = parts[i]
            a = a + fold[0][:, g] * p_lo[g]
            a = a + fold[1][:, g] * xs_lo[:, g:g + 1]
            a = a + fold[2][:, g] * p_hi[g]
            a = a + fold[3][:, g] * xs_hi[:, g:g + 1]
            parts[i] = a
        total = None
        for zi in range(splits):
            acc = parts[zi * kw]
            for w in range(1, kw):
                acc = acc + parts[zi * kw + w]
            total = acc if total is None else total + acc
        out[m0:m0 + rows] = total * sx[m0:m0 + 64].float()
    return out


def _pg_a8_plain(x: torch.Tensor, n: int, k: int, gs: int, launch: Optional[tuple], rule):
    """The plain per-group w4a8 product, ``(xq, sx, packed3, scales,
    zero_points) -> f32``, of the body K8 or K14 runs for x: at ``gs % 32 ==
    0`` :func:`_pg_a8_fold_product` at ``launch`` (default: the launch rule
    ``rule`` on x's card, or on an H100's 132 SMs for a CPU tensor), else
    :func:`_pg_a8_product`."""
    if not _pg_a8_on_tensor_cores(gs):
        return _pg_a8_product
    if launch is None:
        sms = _sm_count(x.device.index) if x.is_cuda else _PLAIN_SMS
        launch = rule(n, k, gs, sms)
    return functools.partial(_pg_a8_fold_product, launch=launch)


def int4_matmul_per_group_a8_reference(x: torch.Tensor, qt: QuantizedTensor, *,
                                       launch: Optional[tuple] = None) -> torch.Tensor:
    """Plain version of K8: the TPU wrapper's activation quantizer, then the
    product in the order of the body K8 runs (:func:`_pg_a8_plain`: at ``gs %
    32 == 0`` the int8 body's fold at ``launch``, by default
    :func:`_linear_a8_launch`'s shape, which reads no M); x.dtype out."""
    int4_matmul_per_group_a8_reference.calls += 1
    n, k = qt.shape
    xq, sx = _quantize_acts(x, fused=True)
    product = _pg_a8_plain(x, n, k, qt.group_size, launch, _linear_a8_launch)
    return product(xq, sx, qt.packed, qt.scales, qt.zero_points).to(x.dtype)


int4_matmul_per_group_a8_reference.calls = 0


def int4_matmul_per_group_a8(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """w4a8 linear for per-group weights: per-row int8 activations, exact
    integer partials per run, at every row count.

    x: [..., K] (bf16 or f32); qt: per_group planar_groups [N, K] with
    ``127 * 128 * gs < 2**24``. Returns [..., N] in x.dtype. The activations
    are quantized before the main kernel with the TPU wrapper's quantizer,
    which XLA compiles with ``amax / 127.0`` folded into a multiply by
    f32(1/127) (``_quantize_acts(x, fused=True)``): at ``gs % 32 == 0`` by the
    int8 body's first pass, at other group sizes by the host quantizer
    (:func:`_pg_a8_on_tensor_cores` says which).
    """
    _check_per_group(qt, a8=True)
    n, k = qt.out_dim, qt.in_dim
    if x.shape[-1] != k:
        raise ValueError(f"x.shape[-1]={x.shape[-1]} != K={k}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if not x.is_cuda:
        return int4_matmul_per_group_a8_reference(x2, qt).reshape(*lead, n)
    if x2.dtype not in _PG_A8_KERNELS:
        raise TypeError(f"K8 takes bf16 or f32 activations, got {x2.dtype}")
    _check_pg_operands(x2, qt, "K8")
    m = x2.shape[0]
    if m == 0:
        return x.new_empty((*lead, n))
    x2 = _aligned(x2)
    if _pg_a8_on_tensor_cores(qt.group_size):
        y = _launch_a8_mma(x2, None, qt, 0, *_linear_a8_launch(n, k, qt.group_size,
                                                               _sm_count(x2.device.index)),
                           fused=True)
    else:
        xq, sx = _quantize_acts(x2, fused=True)
        y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
        with torch.cuda.device(x2.device):
            err = getattr(_build.library(), _PG_A8_KERNELS[x2.dtype])(
                xq.data_ptr(), sx.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(),
                qt.zero_points.data_ptr(), y.data_ptr(), m, n, k, qt.group_size,
                _build.stream_of(x2),
            )
        _build.check(err, "int4_matmul_per_group_a8")
    int4_matmul_per_group_a8.launches += 1
    return y.reshape(*lead, n)


int4_matmul_per_group_a8.launches = 0  # K8
