"""Grouped INT4 product for the MoE experts, over kernels K2, K9, K10, K11,
K12, K13 and K14.

Counterpart of ``fused4bit_tpu/ops/grouped_matmul.py``:
``out[t] = x_sorted[t] @ dequant(W[tile_group_ids[t // tile_m]])^T`` over
tokens sorted by expert, each expert's group zero-padded to a multiple of
``tile_m``. Each wrapper launches once on a CUDA tensor, with no host loop
and no device-to-host sync, and runs its plain version on a CPU tensor:

* ``grouped_int4_matmul`` (w4a16): ``csrc/grouped_matmul.cu``, K2 (the port
  of the TPU kernel ``_grouped_kernel``), or with ``mode="ksplit"`` K9 (the
  port of ``_grouped_ksplit_kernel``: K2 split over K);
* ``grouped_int4_matmul_a8`` (w4a8, per-row int8 activations, exact integer
  dot): ``csrc/grouped_matmul_a8.cu``, K10 (the port of
  ``_grouped_a8_kernel``) on activations quantized before the launch, or
  K11 (the port of ``_grouped_a8_fused_kernel``) quantizing in the kernel;
* ``grouped_int4_matmul_per_group`` (w4a16, per-group experts): in the
  planar_groups layout ``csrc/grouped_matmul_pg.cu``, K13 (the port of
  ``_grouped_pg_bp_kernel``); in the planar layout (what ``models.convert``
  produces) ``csrc/grouped_matmul.cu``, K12 (the port of
  ``_grouped_pg_kernel``);
* ``grouped_int4_matmul_per_group_a8`` (w4a8, the same experts): K14 (the
  port of ``_grouped_pg_bp_a8_kernel``) on activations quantized before the
  launch, as the TPU wrapper does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..quant.core import QuantizedTensor, dequantize
from ..quant.reference import full_precision
from . import _build
from .int4_matmul import (
    _a8_product,
    _check_per_group,
    _check_pg_operands,
    _compute_dtype,
    _pg_a8_product,
    planar_pg_weight,
)
from .int8_xla import _quantize_acts

__all__ = [
    "grouped_int4_matmul", "grouped_int4_matmul_reference",
    "grouped_int4_matmul_a8", "grouped_int4_matmul_a8_reference",
    "grouped_int4_matmul_per_group", "grouped_int4_matmul_per_group_reference",
    "grouped_int4_matmul_per_group_planar_reference",
    "grouped_int4_matmul_per_group_a8", "grouped_int4_matmul_per_group_a8_reference",
]

_KERNELS = {
    torch.bfloat16: "f4b_grouped_int4_matmul_bf16",
    torch.float32: "f4b_grouped_int4_matmul_f32",
}
# x rows per CTA of the kernel (csrc/int4_rows.cuh: RowsTile): an m-tile must
# hold a whole number of them.
_KERNEL_ROWS = {torch.bfloat16: 16, torch.float32: 8}
_A8_KERNELS = {
    torch.bfloat16: "f4b_grouped_int4_matmul_a8_bf16",
    torch.float32: "f4b_grouped_int4_matmul_a8_f32",
}
_A8_FUSED_KERNELS = {
    torch.bfloat16: "f4b_grouped_int4_matmul_a8_fused_bf16",
    torch.float32: "f4b_grouped_int4_matmul_a8_fused_f32",
}
_A8_KERNEL_ROWS = 16  # x rows per CTA of csrc/int4_rows_a8.cuh
_PG_KERNELS = {
    torch.bfloat16: "f4b_grouped_int4_matmul_pg_bf16",
    torch.float32: "f4b_grouped_int4_matmul_pg_f32",
}
_PG_A8_KERNELS = {
    torch.bfloat16: "f4b_grouped_int4_matmul_pg_a8_bf16",
    torch.float32: "f4b_grouped_int4_matmul_pg_a8_f32",
}
_PLANAR_PG_KERNELS = {
    torch.bfloat16: "f4b_grouped_int4_matmul_planar_pg_bf16",
    torch.float32: "f4b_grouped_int4_matmul_planar_pg_f32",
}
_KSPLIT_KERNELS = {
    torch.bfloat16: "f4b_grouped_int4_matmul_ksplit_bf16",
    torch.float32: "f4b_grouped_int4_matmul_ksplit_f32",
}
# grouped_int4_matmul's modes: None, "n_inner", "m_inner" and "x_resident"
# are the TPU kernel's VMEM schedules of one computation (K2 here);
# "ksplit" is K9.
MODES = (None, "n_inner", "m_inner", "x_resident", "ksplit")
# K9's splits: enough CTAs for one per SM of the H100's 132 (a CTA of 32
# output rows x one block of kernel rows; at 166-186 registers per thread one
# CTA of 256 threads is resident per SM), at most one per chunk of 512 packed
# bytes. Past one CTA per SM a split only adds CTAs that walk shorter ranges
# one after another: at the layer2 down projection 2, 4, 7 and 14 splits
# measured 6-87 % slower than 1 at T = 8, 64 and 600 (H100 80GB HBM3, 700 W;
# PERF.md).
_KSPLIT_CTAS = 132
_CHUNK = 512


def _check(x_sorted, tile_group_ids, qt: QuantizedTensor, tile_m: int):
    if qt.granularity != "per_row":
        raise NotImplementedError("the grouped kernel requires per_row scales")
    if qt.layout != "planar":
        raise ValueError("the grouped kernel requires the planar layout")
    _check_tiles(x_sorted, tile_group_ids, qt, tile_m)


def _check_tiles(x_sorted, tile_group_ids, qt: QuantizedTensor, tile_m: int):
    if len(qt.shape) != 3:
        raise ValueError(f"expected stacked [E, N, K] weights, got {qt.shape}")
    t_pad, k = x_sorted.shape
    if k != qt.shape[2]:
        raise ValueError(f"x K={k} != weight K={qt.shape[2]}")
    if t_pad % tile_m != 0 or tile_group_ids.shape != (t_pad // tile_m,):
        raise ValueError(
            f"T_pad={t_pad} must be tile_group_ids.numel()={tile_group_ids.numel()} "
            f"tiles of tile_m={tile_m}"
        )


def _check_device_operands(x_sorted, tile_group_ids, qt: QuantizedTensor) -> None:
    for name, t, want in (
        ("tile_group_ids", tile_group_ids, torch.int32),
        ("packed", qt.packed, torch.uint8),
        ("scales", qt.scales, torch.float32),
        ("zero_points", qt.zero_points, torch.float32),
    ):
        if t.device != x_sorted.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {want} tensor on {x_sorted.device}")


def grouped_int4_matmul_reference(
    x_sorted: torch.Tensor, tile_group_ids: torch.Tensor, qt: QuantizedTensor,
    *, tile_m: int = 64,
) -> torch.Tensor:
    """Plain version of K2: per expert, dequantize and run a float32 matmul
    over that expert's tiles; x.dtype out."""
    grouped_int4_matmul_reference.calls += 1
    _check(x_sorted, tile_group_ids, qt, tile_m)
    return _grouped_golden(x_sorted, tile_group_ids, qt, tile_m)


grouped_int4_matmul_reference.calls = 0


def _grouped_golden(x_sorted, tile_group_ids, qt: QuantizedTensor, tile_m: int,
                    weight=dequantize) -> torch.Tensor:
    """Per expert, dequantize (``weight`` of the expert's QuantizedTensor,
    f32 [N, K]) and run a float32 matmul over that expert's tiles; x.dtype
    out."""
    e, n, k = qt.shape
    xt = x_sorted.reshape(-1, tile_m, k).float()
    out = torch.zeros((xt.shape[0], tile_m, n), dtype=torch.float32, device=x_sorted.device)
    for ex in range(e):
        tiles = (tile_group_ids == ex).nonzero().flatten()
        if tiles.numel() == 0:
            continue
        w = weight(dataclasses.replace(
            qt, packed=qt.packed[ex], scales=qt.scales[ex],
            zero_points=qt.zero_points[ex], shape=(n, k),
        ))
        with full_precision():
            out[tiles] = torch.matmul(xt[tiles], w.t())
    return out.reshape(-1, n).to(x_sorted.dtype)


def _ksplit_splits(t_pad: int, n: int, k: int, rows: int) -> int:
    """K9's number of K splits for a [t_pad, K] x [N, K] product: enough
    CTAs for :data:`_KSPLIT_CTAS`, between 1 and the chunks of K/2 (1 at
    every layer2 shape: the grid fills the card already)."""
    ctas = -(-n // 32) * -(-t_pad // rows)
    return max(1, min(-(-(k // 2) // _CHUNK), -(-_KSPLIT_CTAS // ctas)))


def grouped_int4_matmul(
    x_sorted: torch.Tensor,
    tile_group_ids: torch.Tensor,
    qt: QuantizedTensor,
    *,
    tile_m: int = 64,
    mode: Optional[str] = None,
) -> torch.Tensor:
    """Grouped ``x @ dequant(W[g])^T`` over tile-aligned token groups.

    x_sorted: [T_pad, K] bf16 or f32; tile_group_ids: [T_pad // tile_m] i32;
    qt: stacked per_row planar [E, N, K]. Returns [T_pad, N] in x.dtype.

    ``mode``, as in JAX: ``"ksplit"`` launches K9 (K2 split over K into as
    many ranges as it takes to give every SM a CTA, f32 partial sums added
    in a fixed order: equal to K2 up to the reassociation of the f32 sum).
    ``None``, ``"n_inner"``, ``"m_inner"`` and ``"x_resident"`` launch K2: on the TPU
    they are VMEM schedules of one computation picked by a TPU traffic
    model, which is TPU tuning and not ported. Any other mode raises
    ValueError. On a CPU tensor every mode runs K2's plain version (K9
    computes the same function).
    """
    if mode not in MODES:
        raise ValueError(f"mode={mode!r} is not one of {MODES}")
    if not x_sorted.is_cuda:
        return grouped_int4_matmul_reference(x_sorted, tile_group_ids, qt, tile_m=tile_m)
    _check(x_sorted, tile_group_ids, qt, tile_m)
    e, n, k = qt.shape
    t_pad = x_sorted.shape[0]
    dtype = x_sorted.dtype
    what = "K9" if mode == "ksplit" else "K2"
    if dtype not in _KERNELS:
        raise TypeError(f"{what} takes bf16 or f32 activations, got {dtype}")
    rows = _KERNEL_ROWS[dtype]
    if tile_m % rows != 0:
        raise ValueError(f"{what} needs tile_m % {rows} == 0 for {dtype}")
    if k % 32 != 0:
        raise ValueError(f"{what} needs K % 32 == 0 (16-byte packed rows), got K={k}")
    _check_device_operands(x_sorted, tile_group_ids, qt)
    x_sorted = _aligned_rows(x_sorted)
    y = torch.empty((t_pad, n), dtype=dtype, device=x_sorted.device)
    if t_pad == 0:
        return y
    # scratch: rows in use per block of kernel rows (the zero padding is skipped)
    rows_used = torch.empty((-(-t_pad // rows),), dtype=torch.int32, device=x_sorted.device)
    lib = _build.library()
    head = (x_sorted.data_ptr(), tile_group_ids.data_ptr(), qt.packed.data_ptr(),
            qt.scales.data_ptr(), qt.zero_points.data_ptr(), rows_used.data_ptr())
    with torch.cuda.device(x_sorted.device):
        if mode == "ksplit":
            splits = _ksplit_splits(t_pad, n, k, rows)
            partial = torch.empty((splits, t_pad, n), dtype=torch.float32,
                                  device=x_sorted.device)
            err = getattr(lib, _KSPLIT_KERNELS[dtype])(
                *head, partial.data_ptr(), y.data_ptr(), t_pad, n, k, tile_m, splits,
                _build.stream_of(x_sorted))
        else:
            err = getattr(lib, _KERNELS[dtype])(
                *head, y.data_ptr(), t_pad, n, k, tile_m, _build.stream_of(x_sorted))
    _build.check(err, "grouped_int4_matmul")
    if mode == "ksplit":
        grouped_int4_matmul.ksplit_launches += 1
    else:
        grouped_int4_matmul.launches += 1
    return y


grouped_int4_matmul.launches = 0         # K2
grouped_int4_matmul.ksplit_launches = 0  # K9


def _check_a8(x_sorted, tile_group_ids, qt: QuantizedTensor, tile_m: int) -> None:
    if tile_m % 32 != 0:
        raise ValueError(f"tile_m={tile_m} must be a multiple of 32 for int8")
    _check(x_sorted, tile_group_ids, qt, tile_m)


def grouped_int4_matmul_a8_reference(
    x_sorted: torch.Tensor, tile_group_ids: torch.Tensor, qt: QuantizedTensor,
    *, tile_m: int = 32, fuse_quant: bool = False,
) -> torch.Tensor:
    """Plain version of K10 and K11: quantize (with K11's quantizer when
    ``fuse_quant``, see :func:`~.int8_xla._quantize_acts`), then per expert
    the exact dot and JAX's epilogue over that expert's tiles; x.dtype out."""
    grouped_int4_matmul_a8_reference.calls += 1
    _check_a8(x_sorted, tile_group_ids, qt, tile_m)
    e, n, k = qt.shape
    xq, sx = _quantize_acts(x_sorted, fused=fuse_quant)
    xqt, sxt = xq.reshape(-1, tile_m, k), sx.reshape(-1, tile_m, 1)
    out = torch.zeros((xqt.shape[0], tile_m, n), dtype=torch.float32, device=x_sorted.device)
    for ex in range(e):
        tiles = (tile_group_ids == ex).nonzero().flatten()
        if tiles.numel() == 0:
            continue
        y = _a8_product(xqt[tiles].reshape(-1, k), sxt[tiles].reshape(-1, 1),
                        qt.packed[ex], qt.scales[ex], qt.zero_points[ex])
        out[tiles] = y.reshape(-1, tile_m, n)
    return out.reshape(-1, n).to(x_sorted.dtype)


grouped_int4_matmul_a8_reference.calls = 0


def grouped_int4_matmul_a8(
    x_sorted: torch.Tensor,
    tile_group_ids: torch.Tensor,
    qt: QuantizedTensor,
    *,
    tile_m: int = 32,
    fuse_quant: Optional[bool] = None,
) -> torch.Tensor:
    """w4a8 grouped ``x @ dequant(W[g])^T`` over tile-aligned token groups.

    x_sorted: [T_pad, K] bf16 or f32; tile_group_ids: [T_pad // tile_m] i32;
    qt: stacked per_row planar [E, N, K]; tile_m a multiple of 32. Returns
    [T_pad, N] in x.dtype. ``fuse_quant``: quantize inside the kernel (K11)
    rather than before it (K10); None means False, as in JAX. On a CPU tensor
    the plain version runs with the quantizer of the kernel it picks.
    """
    fuse_quant = bool(fuse_quant)
    if not x_sorted.is_cuda:
        return grouped_int4_matmul_a8_reference(x_sorted, tile_group_ids, qt, tile_m=tile_m,
                                                fuse_quant=fuse_quant)
    _check_a8(x_sorted, tile_group_ids, qt, tile_m)
    e, n, k = qt.shape
    t_pad = x_sorted.shape[0]
    dtype = x_sorted.dtype
    if dtype not in _A8_KERNELS:
        raise TypeError(f"K10/K11 take bf16 or f32 activations, got {dtype}")
    if k % 32 != 0:
        raise ValueError(f"K10/K11 need K % 32 == 0 (16-byte packed rows), got K={k}")
    _check_device_operands(x_sorted, tile_group_ids, qt)
    x_sorted = x_sorted.contiguous()
    if x_sorted.data_ptr() % 16:  # the kernel reads x with 16-byte loads
        x_sorted = x_sorted.clone()
    y = torch.empty((t_pad, n), dtype=dtype, device=x_sorted.device)
    if t_pad == 0:
        return y
    # scratch: rows in use per block of kernel rows (the zero padding is skipped)
    rows_used = torch.empty((-(-t_pad // _A8_KERNEL_ROWS),), dtype=torch.int32,
                            device=x_sorted.device)
    lib = _build.library()
    tail = (tile_group_ids.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(),
            qt.zero_points.data_ptr(), rows_used.data_ptr(), y.data_ptr(), t_pad, n, k, tile_m,
            _build.stream_of(x_sorted))
    with torch.cuda.device(x_sorted.device):
        if fuse_quant:
            err = getattr(lib, _A8_FUSED_KERNELS[dtype])(x_sorted.data_ptr(), *tail)
        else:
            xq, sx = _quantize_acts(x_sorted)
            err = getattr(lib, _A8_KERNELS[dtype])(xq.data_ptr(), sx.data_ptr(), *tail)
    _build.check(err, "grouped_int4_matmul_a8")
    if fuse_quant:
        grouped_int4_matmul_a8.fused_launches += 1
    else:
        grouped_int4_matmul_a8.launches += 1
    return y


grouped_int4_matmul_a8.launches = 0        # K10
grouped_int4_matmul_a8.fused_launches = 0  # K11


# --- per-group experts in the planar_groups layout: K13 (w4a16), K14 (w4a8) ---


def _check_pg(x_sorted, tile_group_ids, qt: QuantizedTensor, tile_m: int, *,
              a8: bool = False) -> None:
    if a8 and tile_m % 32 != 0:
        raise ValueError(f"tile_m={tile_m} must be a multiple of 32 for int8")
    _check_per_group(qt, a8=a8)
    _check_tiles(x_sorted, tile_group_ids, qt, tile_m)


def _launch_pg(kernels, what, xin, sx, x_sorted, tile_group_ids, qt, tile_m, rows):
    """One launch of K12 or K13 (sx None) or K14 over every tile; rows per
    CTA ``rows``."""
    _check_device_operands(x_sorted, tile_group_ids, qt)
    _check_pg_operands(x_sorted, qt, what)
    if tile_m % rows != 0:
        raise ValueError(f"{what} needs tile_m % {rows} == 0 for {x_sorted.dtype}")
    e, n, k = qt.shape
    t_pad = x_sorted.shape[0]
    y = torch.empty((t_pad, n), dtype=x_sorted.dtype, device=x_sorted.device)
    if t_pad == 0:
        return y
    # scratch: rows in use per block of kernel rows (the zero padding is skipped)
    rows_used = torch.empty((-(-t_pad // rows),), dtype=torch.int32, device=x_sorted.device)
    head = (xin.data_ptr(),) if sx is None else (xin.data_ptr(), sx.data_ptr())
    with torch.cuda.device(x_sorted.device):
        err = getattr(_build.library(), kernels[x_sorted.dtype])(
            *head, tile_group_ids.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(),
            qt.zero_points.data_ptr(), rows_used.data_ptr(), y.data_ptr(), t_pad, n, k,
            qt.group_size, tile_m, _build.stream_of(x_sorted),
        )
    _build.check(err, what)
    return y


def _aligned_rows(x_sorted: torch.Tensor) -> torch.Tensor:
    x_sorted = x_sorted.contiguous()
    return x_sorted.clone() if x_sorted.data_ptr() % 16 else x_sorted  # 16-byte loads


def grouped_int4_matmul_per_group_reference(
    x_sorted: torch.Tensor, tile_group_ids: torch.Tensor, qt: QuantizedTensor,
    *, tile_m: int = 64,
) -> torch.Tensor:
    """Plain version of K13: per expert, dequantize and run a float32 matmul
    over that expert's tiles; x.dtype out. Any per_group stack: it is also
    the golden path of the per-group group sizes no kernel serves
    (``MoEINT4``, as in JAX)."""
    grouped_int4_matmul_per_group_reference.calls += 1
    _check_tiles(x_sorted, tile_group_ids, qt, tile_m)
    return _grouped_golden(x_sorted, tile_group_ids, qt, tile_m)


grouped_int4_matmul_per_group_reference.calls = 0


def grouped_int4_matmul_per_group_planar_reference(
    x_sorted: torch.Tensor, tile_group_ids: torch.Tensor, qt: QuantizedTensor,
    *, tile_m: int = 64,
) -> torch.Tensor:
    """Plain version of K12: per expert, the weight dequantized to the
    compute type as the TPU kernel does (``int4_matmul.planar_pg_weight``),
    then a float32 matmul over that expert's tiles; x.dtype out."""
    grouped_int4_matmul_per_group_planar_reference.calls += 1
    _check_tiles(x_sorted, tile_group_ids, qt, tile_m)
    cd = _compute_dtype(x_sorted)
    return _grouped_golden(x_sorted, tile_group_ids, qt, tile_m, weight=lambda q: planar_pg_weight(
        q.packed, q.scales, q.zero_points, q.group_size, cd))


grouped_int4_matmul_per_group_planar_reference.calls = 0


def grouped_int4_matmul_per_group(
    x_sorted: torch.Tensor,
    tile_group_ids: torch.Tensor,
    qt: QuantizedTensor,
    *,
    tile_m: int = 64,
) -> torch.Tensor:
    """Grouped ``x @ dequant(W[g])^T`` over per-group experts.

    x_sorted: [T_pad, K] bf16 or f32; tile_group_ids: [T_pad // tile_m] i32;
    qt: stacked per_group [E, N, K], planar_groups with gs a multiple of 16
    dividing K/2 (K13) or planar with gs a multiple of 128 dividing K/2 (K12;
    see ``int4_matmul._check_per_group``). Returns [T_pad, N] in x.dtype.
    """
    _check_pg(x_sorted, tile_group_ids, qt, tile_m)
    planar = qt.layout == "planar"
    if not x_sorted.is_cuda:
        plain = (grouped_int4_matmul_per_group_planar_reference if planar
                 else grouped_int4_matmul_per_group_reference)
        return plain(x_sorted, tile_group_ids, qt, tile_m=tile_m)
    what = "K12" if planar else "K13"
    if x_sorted.dtype not in _PG_KERNELS:
        raise TypeError(f"{what} takes bf16 or f32 activations, got {x_sorted.dtype}")
    x_sorted = _aligned_rows(x_sorted)
    y = _launch_pg(_PLANAR_PG_KERNELS if planar else _PG_KERNELS, what, x_sorted, None,
                   x_sorted, tile_group_ids, qt, tile_m, _KERNEL_ROWS[x_sorted.dtype])
    if planar:
        grouped_int4_matmul_per_group.planar_launches += 1
    else:
        grouped_int4_matmul_per_group.launches += 1
    return y


grouped_int4_matmul_per_group.launches = 0         # K13
grouped_int4_matmul_per_group.planar_launches = 0  # K12


def grouped_int4_matmul_per_group_a8_reference(
    x_sorted: torch.Tensor, tile_group_ids: torch.Tensor, qt: QuantizedTensor,
    *, tile_m: int = 64,
) -> torch.Tensor:
    """Plain version of K14: the TPU wrapper's quantizer, then per expert
    :func:`~.int4_matmul._pg_a8_product` over that expert's tiles; x.dtype
    out."""
    grouped_int4_matmul_per_group_a8_reference.calls += 1
    _check_pg(x_sorted, tile_group_ids, qt, tile_m, a8=True)
    e, n, k = qt.shape
    xq, sx = _quantize_acts(x_sorted, fused=True)
    xqt, sxt = xq.reshape(-1, tile_m, k), sx.reshape(-1, tile_m, 1)
    out = torch.zeros((xqt.shape[0], tile_m, n), dtype=torch.float32, device=x_sorted.device)
    for ex in range(e):
        tiles = (tile_group_ids == ex).nonzero().flatten()
        if tiles.numel() == 0:
            continue
        y = _pg_a8_product(xqt[tiles].reshape(-1, k), sxt[tiles].reshape(-1, 1),
                           qt.packed[ex], qt.scales[ex], qt.zero_points[ex])
        out[tiles] = y.reshape(-1, tile_m, n)
    return out.reshape(-1, n).to(x_sorted.dtype)


grouped_int4_matmul_per_group_a8_reference.calls = 0


def grouped_int4_matmul_per_group_a8(
    x_sorted: torch.Tensor,
    tile_group_ids: torch.Tensor,
    qt: QuantizedTensor,
    *,
    tile_m: int = 64,
) -> torch.Tensor:
    """w4a8 grouped ``x @ dequant(W[g])^T`` over per-group experts.

    x_sorted: [T_pad, K] bf16 or f32; tile_group_ids: [T_pad // tile_m] i32;
    qt: stacked per_group planar_groups [E, N, K] with ``127*128*gs < 2**24``;
    tile_m a multiple of 32. Returns [T_pad, N] in x.dtype. The activations
    are quantized before the launch with the TPU wrapper's quantizer
    (``_quantize_acts(x, fused=True)``, see ``int4_matmul_per_group_a8``).
    """
    _check_pg(x_sorted, tile_group_ids, qt, tile_m, a8=True)
    if not x_sorted.is_cuda:
        return grouped_int4_matmul_per_group_a8_reference(x_sorted, tile_group_ids, qt,
                                                          tile_m=tile_m)
    if x_sorted.dtype not in _PG_A8_KERNELS:
        raise TypeError(f"K14 takes bf16 or f32 activations, got {x_sorted.dtype}")
    xq, sx = _quantize_acts(x_sorted, fused=True)
    y = _launch_pg(_PG_A8_KERNELS, "grouped_int4_matmul_per_group_a8", xq, sx, x_sorted,
                   tile_group_ids, qt, tile_m, _A8_KERNEL_ROWS)
    grouped_int4_matmul_per_group_a8.launches += 1
    return y


grouped_int4_matmul_per_group_a8.launches = 0  # K14
