"""What the wrappers of ``int4_matmul`` and ``grouped_matmul`` share: the
weights' format checks, made before the CPU/CUDA split so both devices
accept the same weights, and the front end every wrapper runs once between
choosing its call's body and launching it. Also the card's SM count, which
the launch rules of the body modules read, and the compute type of the
plain versions of K6 and K12.
"""
from __future__ import annotations

import functools

import torch

from ..quant.core import QuantizedTensor

# x rows per CTA of a grouped call (bf16: the tensor-core body's decode tile;
# f32: the CUDA-core loops of csrc/int4_rows.cuh, RowsTile): an m-tile must
# hold a whole number of them.
_KERNEL_ROWS = {torch.bfloat16: 16, torch.float32: 8}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The TPU kernels' compute type: f32 for f32 activations, else bf16."""
    return torch.float32 if x.dtype == torch.float32 else torch.bfloat16


def _check_per_row(qt: QuantizedTensor) -> None:
    """The format check of the per-row wrappers (K1, K4/K5; K2/K9, K10/K11)."""
    if qt.granularity != "per_row":
        raise NotImplementedError(f"the kernel supports per_row scales; got {qt.granularity}")
    if qt.layout != "planar":
        raise ValueError(f"the kernel requires the planar layout; got {qt.layout}")


def _check_per_group(qt: QuantizedTensor, *, a8: bool = False) -> None:
    """The format checks of the per-group wrappers (K6/K7, K8, K12/K13, K14).

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


def _prepare(what: str, x: torch.Tensor, qt: QuantizedTensor, body: str, plain, *,
             gids=None, tile_m: int = 0) -> tuple:
    """The preamble of every wrapper, once its weights' format is checked and
    the body of its call (``body``) chosen: x [..., K] as rows ``x2`` [M, K];
    for the dense path or the plain version (body "dense" or "plain")
    ``plain(x2)``; else the checks of a launch named ``what`` (bf16 or f32
    x, K % 32 == 0, a grouped call's tile_m in whole blocks of the kernel's
    rows, and the device, type, contiguity and shape of ``gids`` (the tile
    map), packed, scales and zero points), then an empty [0, N] where x has
    no rows. Returns ``(x2, y)``: y that output, or None where a kernel is
    to run on x2, 16-byte aligned."""
    k, n = qt.shape[-1], qt.shape[-2]
    if x.shape[-1] != k:
        raise ValueError(f"x.shape[-1]={x.shape[-1]} != K={k}")
    x2 = x.reshape(-1, k)
    if body in ("dense", "plain"):
        return x2, plain(x2)
    if x2.dtype not in _KERNEL_ROWS:
        raise TypeError(f"{what} takes bf16 or f32 activations, got {x2.dtype}")
    if k % 32 != 0:
        raise ValueError(f"{what} needs K % 32 == 0 (16-byte packed rows), got K={k}")
    rows = _KERNEL_ROWS[x2.dtype]
    if gids is not None and tile_m % rows != 0:
        raise ValueError(f"{what} needs tile_m % {rows} == 0 for {x2.dtype}")
    # packed [..., Gh, N, gs] (planar_groups) or [..., N, K/2] (planar);
    # per group, scales and zero points [..., N, K/gs]
    gs, kh, lead = qt.group_size, k // 2, qt.shape[:-2]
    want = (*lead, kh // gs, n, gs) if qt.layout == "planar_groups" else (*lead, n, kh)
    if tuple(qt.packed.shape) != want:
        raise ValueError(f"{what}: packed shape {tuple(qt.packed.shape)} != {want}")
    for name, t, dtype in (
        ("tile_group_ids", gids, torch.int32),
        ("packed", qt.packed, torch.uint8),
        ("scales", qt.scales, torch.float32),
        ("zero_points", qt.zero_points, torch.float32),
    ):
        if t is None:
            continue
        if t.device != x2.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {x2.device}")
        if gs and name in ("scales", "zero_points") and tuple(t.shape) != (*lead, n, 2 * kh // gs):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != {(*lead, n, 2 * kh // gs)}")
    if x2.shape[0] == 0:
        return x2, x2.new_empty((0, n))
    x2 = x2.contiguous()
    return (x2.clone() if x2.data_ptr() % 16 else x2), None  # the kernels read x with 16-byte loads
