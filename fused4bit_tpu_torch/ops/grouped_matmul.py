"""Grouped INT4 product for the MoE experts, over kernels K2, K9, K10, K11,
K12, K13 and K14.

Counterpart of ``fused4bit_tpu/ops/grouped_matmul.py``:
``out[t] = x_sorted[t] @ dequant(W[tile_group_ids[t // tile_m]])^T`` over
tokens sorted by expert, each expert's group zero-padded to a multiple of
``tile_m``. Each wrapper launches once on a CUDA tensor, with no host loop
and no device-to-host sync, and runs its plain version on a CPU tensor:

* ``grouped_int4_matmul`` (w4a16): ``csrc/grouped_matmul.cu``, K2 (the port
  of the TPU kernel ``_grouped_kernel``), or with ``mode="ksplit"`` K9 (the
  port of ``_grouped_ksplit_kernel``): bf16 on the tensor-core body of
  ``csrc/int4_mma.cuh`` (K9 with K split across CTAs, the ordered second
  pass adding them), f32 on the CUDA-core loop of ``csrc/int4_rows.cuh``
  (K9's split over K as well);
* ``grouped_int4_matmul_a8`` (w4a8, per-row int8 activations, exact integer
  dot): ``csrc/grouped_matmul_a8.cu``, K10 (the port of
  ``_grouped_a8_kernel``) and K11 (the port of ``_grouped_a8_fused_kernel``),
  both on the int8 tensor-core body of ``csrc/int8_mma.cuh`` after a first
  pass that quantizes the rows: K10 with the host quantizer's division by
  127, K11 with XLA's folded multiply by f32(1/127);
* ``grouped_int4_matmul_per_group`` (w4a16, per-group experts): in the
  planar_groups layout ``csrc/grouped_matmul_pg.cu``, K13 (the port of
  ``_grouped_pg_bp_kernel``; bf16 at ``gs % 64 == 0`` on the tensor-core
  body, else the CUDA-core loop of ``csrc/int4_rows_pg.cuh``); in the
  planar layout (what ``models.convert`` produces) ``csrc/grouped_matmul.cu``,
  K12 (the port of ``_grouped_pg_kernel``; bf16 on the tensor-core body
  under K6's arithmetic, f32 on the CUDA-core loop of ``csrc/int4_rows.cuh``);
* ``grouped_int4_matmul_per_group_a8`` (w4a8, the same experts): K14 (the
  port of ``_grouped_pg_bp_a8_kernel``) on activations quantized before the
  main kernel, as the TPU wrapper does: at ``gs % 32 == 0`` on the int8
  tensor-core body (its first pass quantizes), else on the CUDA-core loop of
  ``csrc/int4_rows_pg.cuh``.

The tensor-core bodies' launch shapes come from :func:`_grouped_mma_launch`
(K2, K12, K13), :func:`_ksplit_mma_launch` (K9) and
``int4_matmul._a8_mma_launch`` (K10, K11, K14), which read (N, K, SM count)
and (N, K, gs, SM count) only: a token row's output bits do not depend on
the tile, the T or the routing it sits in (K2, K12 and K13 up to tile_m 64;
at tile_m 128, the prefill's, they take 64-row tiles whose launch may read
T; K9 keeps its own launch there too).

bf16 K2 and K13 calls of at least :data:`WG_MIN_EXPERT_ROWS` routed rows an
expert (T_pad less the experts' padding, ``E * tile_m``, over E; at whole
slices of N and whole chunks of K; :func:`_wg_body`) run the warpgroup body
of ``csrc/grouped_wgmma.cu`` instead: one CTA holds all of an
expert's routed rows for a slice of 128 output features and walks K once, so
each weight byte is streamed and dequantized once per call. Its sums run in
an order fixed by (N, K): a row's bits do not depend on the T_pad, the tile_m
or the routing within its domain either.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..quant.core import QuantizedTensor, dequantize
from ..quant.reference import full_precision
from . import _build
from .int4_matmul import (
    _A8_PREPASS,
    _MMA_TALL_M,
    _WG_CHUNK,
    _WG_SLICE,
    _a8_mma_launch,
    _a8_product,
    _check_per_group,
    _check_pg_operands,
    _compute_dtype,
    _k7_on_tensor_cores,
    _launch_a8_mma,
    _mma_tall_launch,
    _pg_a8_on_tensor_cores,
    _pg_a8_plain,
    _sm_count,
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
    torch.bfloat16: "f4b_grouped_int4_matmul_mma_bf16",   # K2 on the tensor-core body
    torch.float32: "f4b_grouped_int4_matmul_f32",
}
_PG_MMA_KERNEL = "f4b_grouped_int4_matmul_pg_mma_bf16"   # K13 on the tensor-core body
_PLANAR_PG_MMA_KERNEL = "f4b_grouped_int4_matmul_planar_pg_mma_bf16"   # K12 on it
# K2 and K13 on the warpgroup body (csrc/grouped_wgmma.cu)
_WG_KERNELS = {"per_row": "f4b_grouped_int4_matmul_wg_bf16",
               "per_group": "f4b_grouped_int4_matmul_pg_wg_bf16"}
# x rows per CTA (bf16: the tensor-core body's decode tile; the CUDA-core
# loops of csrc/int4_rows.cuh, RowsTile): an m-tile must hold a whole number
# of them.
_KERNEL_ROWS = {torch.bfloat16: 16, torch.float32: 8}
# x rows per CTA of K14's CUDA-core loop (csrc/int4_rows_pg.cuh), at group
# sizes the int8 body does not take
_A8_KERNEL_ROWS = 16
_PG_KERNELS = {
    torch.bfloat16: "f4b_grouped_int4_matmul_pg_bf16",
    torch.float32: "f4b_grouped_int4_matmul_pg_f32",
}
_PG_A8_KERNELS = {
    torch.bfloat16: "f4b_grouped_int4_matmul_pg_a8_bf16",
    torch.float32: "f4b_grouped_int4_matmul_pg_a8_f32",
}
_PLANAR_PG_KERNELS = {torch.float32: "f4b_grouped_int4_matmul_planar_pg_f32"}   # K12 in f32
# grouped_int4_matmul's modes: None, "n_inner", "m_inner" and "x_resident"
# are the TPU kernel's VMEM schedules of one computation (K2 here);
# "ksplit" is K9.
MODES = (None, "n_inner", "m_inner", "x_resident", "ksplit")
_CHUNK = 512   # packed bytes per chunk of the CUDA-core loop (f32 K9)


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
    over that expert's tiles; x.dtype out. Any format: it is also the golden
    path of the formats no grouped kernel takes (per_tensor, the interleaved
    and block_planar layouts; ``MoEINT4``, as in JAX)."""
    grouped_int4_matmul_reference.calls += 1
    _check_tiles(x_sorted, tile_group_ids, qt, tile_m)
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


def _ksplit_splits(t_pad: int, n: int, k: int, rows: int, sms: int) -> int:
    """f32 K9's number of K splits on the CUDA-core loop for a [t_pad, K] x
    [N, K] product (``rows`` x rows per CTA) on a card of ``sms`` SMs: enough
    CTAs (32 output rows x one block of rows each) for one per SM, between 1
    and the chunks of K/2 (1 at every layer2 shape: the grid fills the card
    already)."""
    ctas = -(-n // 32) * -(-t_pad // rows)
    return max(1, min(-(-(k // 2) // _CHUNK), -(-sms // ctas)))


# --- the tensor-core body (csrc/int4_mma.cuh) with grouped addressing: K2, K12, K13 ---


def _k12_on_tensor_cores(dtype: torch.dtype) -> bool:
    """K12's body, chosen by the activations' type alone, as K6's: the
    tensor-core body (``csrc/int4_mma.cuh``, GroupDequant with grouped
    addressing) for bf16 x, the CUDA-core loop of ``csrc/int4_rows.cuh``
    for f32 x (an f32 tensor-core product would be TF32)."""
    return dtype == torch.bfloat16


def _grouped_mma_launch(n: int, k: int, sms: int) -> tuple:
    """The launch shape ``(ws, kw, splits)`` of the tensor-core body for K2,
    K12 and K13 at tile_m <= 64, for an [N, K] expert weight on a card of
    ``sms`` SMs: each warp takes a 16-row tile of output rows and ``ws`` k
    steps (whole chunks of 64 packed bytes, 8 steps each, so K13 folds whole
    chunks), a CTA of 8 warps puts ``kw`` of them along K (8 / kw row tiles),
    and ``splits`` CTAs cover K.

    K/2 is cut into the fewest slices that give every SM two warps from one
    block of 16 rows alone (a decode step where one expert is hit); the
    slices go to warps of a CTA first (up to 8, added through shared
    memory), then to CTAs along K (added by a second pass).

    It reads (N, K, SMs) only, never T, tile_m or the routing: a token row's
    sums then run in the same order wherever it sits, so its output bits do
    not depend on the tile, the tile_m or the T of its dispatch."""
    tiles = -(-n // 16)
    chunks = -(-(k // 2) // 64)
    slices = max(1, min(chunks, -(-2 * sms // tiles)))
    kw = min(8, 1 << (slices - 1).bit_length())
    ws = 8 * -(-chunks // (kw * -(-slices // kw)))
    return ws, kw, -(-8 * chunks // (kw * ws))


def _ksplit_mma_launch(n: int, k: int, sms: int) -> tuple:
    """K9's launch shape ``(ws, 1, splits)`` on the tensor-core body (see
    :func:`_grouped_mma_launch`) for an [N, K] expert weight on a card of
    ``sms`` SMs, at every tile_m (the 64-row tile at tile_m 128 as well).

    K/2 is cut into :func:`_grouped_mma_launch`'s count of slices, at least
    two, of whole chunks; unlike K2's rule it hands each slice to a CTA
    along K, and the body's ordered second pass adds them: the GPU form of
    the TPU kernel's k grid axis, which carries one f32 sum across its k
    tiles. K is left whole only where K/2 is a single chunk. At the layer2
    down projection that is 2 CTAs along K, one warp each; 4 and 7 CTAs, and
    two warps along K per CTA, measured at most 4 % faster at T = 8 and 64
    and 4-42 % slower at T = 600 on the H100 (``scripts/ksplit_sweep.py``;
    PERF.md).

    It reads (N, K, SMs) only, never T, tile_m or the routing: a token row's
    sums then run in the same order wherever it sits, so its output bits do
    not depend on the tile, the tile_m or the T of its dispatch."""
    tiles = -(-n // 16)
    chunks = -(-(k // 2) // 64)
    splits = min(chunks, max(2, -(-2 * sms // tiles)))
    ws = 8 * -(-chunks // splits)
    return ws, 1, -(-8 * chunks // ws)


# Routed rows an expert from which a bf16 K2 or K13 call runs the warpgroup
# body: ``T_pad - E * tile_m`` (a dropless plan's T_pad less the tile of
# padding it gives each expert, fixed at capture) over E. Measured on the
# H100 (scripts/grouped_mma_sweep.py --crossover; PERF.md) at 8 experts
# top-2 (the benchmark cells' widths), 16 top-2 and 64 top-8: at 24 rows an
# expert the body is the faster in every projection (1.2-1.6x), at 20 too
# (16 and 64 experts), at 16 in all but K13 at 64 experts, and from 12 rows
# down it loses, by up to 1.9x. There an expert's rows fit one tile, its
# weights stream once on either body, and the old body's split of K across
# many CTAs fills the card: decode (T=8) and the self-draft verify (T=40)
# stay on it at 8 to 128 experts.
WG_MIN_EXPERT_ROWS = 24


def _wg_body(dtype: torch.dtype, granularity: str, group_size: int, t_pad: int, e: int,
             tile_m: int, n: int, k: int) -> bool:
    """Whether a grouped w4a16 call runs the warpgroup body
    (``csrc/grouped_wgmma.cu``) rather than ``csrc/int4_mma.cuh``'s: bf16 x,
    per row (K2) or per group with ``group_size % 64 == 0`` dividing K/2
    (K13 at K7's group sizes), N in whole slices of 128, K/2 in whole chunks
    of 64 bytes, and at least :data:`WG_MIN_EXPERT_ROWS` rows an expert
    beyond the padding (``t_pad - e * tile_m >= e * WG_MIN_EXPERT_ROWS``).
    It reads the call's shapes, tile size and format only, never the tile
    map's contents, the rows' or the routing, so a CUDA graph replays the
    body its capture chose."""
    if dtype != torch.bfloat16 or t_pad - e * tile_m < e * WG_MIN_EXPERT_ROWS:
        return False
    if n % _WG_SLICE or (k // 2) % _WG_CHUNK:
        return False
    if granularity == "per_row":
        return True
    return (granularity == "per_group" and group_size > 0 and group_size % _WG_CHUNK == 0
            and (k // 2) % group_size == 0)


def _wg_grid(e: int, n: int, sms: int) -> int:
    """The warpgroup body's persistent grid: a CTA per SM, at most one per
    work item (an expert's slice of 128 output features). It reads (E, N,
    SMs) only, never the routing."""
    return max(1, min(e * (n // _WG_SLICE), sms))


def _launch_grouped_wg(x_sorted: torch.Tensor, tile_group_ids: torch.Tensor,
                       qt: QuantizedTensor, tile_m: int) -> torch.Tensor:
    """K2 (per_row ``qt``) or K13 (per_group, planar_groups) on the warpgroup
    body: its first pass (the rows in use; K13 also the x sums of every chunk
    and half), then the persistent main kernel on :func:`_wg_grid`'s CTAs.
    Operands checked, x_sorted 16-byte aligned."""
    m, k = x_sorted.shape
    e, n, _ = qt.shape
    dev = x_sorted.device
    fold = qt.granularity == "per_group"
    if qt.packed.data_ptr() % 16:
        raise ValueError("the warpgroup body needs 16-byte aligned packed weights")
    y = torch.empty((m, n), dtype=x_sorted.dtype, device=dev)
    if m == 0:
        return y
    used = torch.empty((m,), dtype=torch.int32, device=dev)
    xsum = torch.empty((k // _WG_CHUNK, m), dtype=torch.float32, device=dev) if fold else None
    grid = _wg_grid(e, n, _sm_count(dev.index))
    with torch.cuda.device(dev):
        err = getattr(_build.library(), _WG_KERNELS[qt.granularity])(
            x_sorted.data_ptr(), tile_group_ids.data_ptr(), qt.packed.data_ptr(),
            qt.scales.data_ptr(), qt.zero_points.data_ptr(), used.data_ptr(),
            *([xsum.data_ptr()] if fold else []), y.data_ptr(), m, n, k, e,
            *([qt.group_size] if fold else []), tile_m, grid, _build.stream_of(x_sorted))
    _build.check(err, "grouped_int4_matmul_per_group" if fold else "grouped_int4_matmul")
    return y


def _launch_grouped_mma(x_sorted: torch.Tensor, tile_group_ids: torch.Tensor, qt: QuantizedTensor,
                        tile_m: int, *, launch: Optional[tuple] = None) -> torch.Tensor:
    """K2 (per_row ``qt``; K9 at :func:`_ksplit_mma_launch`'s ``launch``),
    K12 (per_group, planar) or K13 (per_group, planar_groups) on the
    tensor-core body: its first pass (which rows hold a nonzero), the main
    kernel with 16 rows of x per CTA at :func:`_grouped_mma_launch`'s shape,
    or at tile_m 128 (a multiple of 64 above 64: the prefill's tiles) with
    64 at :func:`~.int4_matmul._mma_tall_launch`'s (either at ``launch``
    where given), and with splits > 1 the ordered second pass. x_sorted
    16-byte aligned, operands checked."""
    m, k = x_sorted.shape
    n = qt.shape[1]
    dev = x_sorted.device
    sms = _sm_count(dev.index)
    tall = tile_m > _MMA_TALL_M and tile_m % _MMA_TALL_M == 0
    if launch is None:
        launch = _mma_tall_launch(n, k, m, sms) if tall else _grouped_mma_launch(n, k, sms)
    ws, kw, splits = launch
    per_group = qt.granularity == "per_group"
    kernel = (_KERNELS[torch.bfloat16] if not per_group else
              _PLANAR_PG_MMA_KERNEL if qt.layout == "planar" else _PG_MMA_KERNEL)
    y = torch.empty((m, n), dtype=x_sorted.dtype, device=dev)
    if m == 0:
        return y
    used = torch.empty((m,), dtype=torch.int32, device=dev)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    with torch.cuda.device(dev):
        err = getattr(_build.library(), kernel)(
            x_sorted.data_ptr(), tile_group_ids.data_ptr(), qt.packed.data_ptr(),
            qt.scales.data_ptr(), qt.zero_points.data_ptr(), used.data_ptr(), y.data_ptr(),
            None if partial is None else partial.data_ptr(), m, n, k,
            *([qt.group_size] if per_group else []), tile_m, ws, kw, splits,
            _MMA_TALL_M if tall else 16, _build.stream_of(x_sorted))
    _build.check(err, "grouped_int4_matmul_per_group" if per_group else "grouped_int4_matmul")
    return y


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
    K2 runs bf16 x on the tensor-core body (:func:`_launch_grouped_mma`),
    or from :data:`WG_MIN_EXPERT_ROWS` rows an expert on the warpgroup body
    (:func:`_launch_grouped_wg`, :func:`_wg_body`), f32 x on the CUDA-core
    loop.

    ``mode``, as in JAX: ``"ksplit"`` launches K9, the same function as K2
    with its f32 sums in another order: bf16 x on the tensor-core body at
    :func:`_ksplit_mma_launch`'s shape (K split across CTAs, their f32
    partials added in a fixed order by the second pass), f32 x on the
    CUDA-core loop split over K (:func:`_ksplit_splits`).
    ``None``, ``"n_inner"``, ``"m_inner"`` and ``"x_resident"`` launch K2: on the TPU
    they are VMEM schedules of one computation picked by a TPU traffic
    model, which is TPU tuning and not ported. Any other mode raises
    ValueError. On a CPU tensor every mode runs K2's plain version (K9
    computes the same function).
    """
    if mode not in MODES:
        raise ValueError(f"mode={mode!r} is not one of {MODES}")
    _check(x_sorted, tile_group_ids, qt, tile_m)
    if not x_sorted.is_cuda:
        return grouped_int4_matmul_reference(x_sorted, tile_group_ids, qt, tile_m=tile_m)
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
    sms = _sm_count(x_sorted.device.index)
    wg = mode != "ksplit" and _wg_body(dtype, qt.granularity, 0, t_pad, e, tile_m, n, k)
    if wg:
        y = _launch_grouped_wg(x_sorted, tile_group_ids, qt, tile_m)
    elif dtype == torch.bfloat16:
        y = _launch_grouped_mma(x_sorted, tile_group_ids, qt, tile_m,
                                launch=_ksplit_mma_launch(n, k, sms) if mode == "ksplit" else None)
    else:
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
                splits = _ksplit_splits(t_pad, n, k, rows, sms)
                partial = torch.empty((splits, t_pad, n), dtype=torch.float32,
                                      device=x_sorted.device)
                err = lib.f4b_grouped_int4_matmul_ksplit_f32(
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
        grouped_int4_matmul.wg_launches += wg
    return y


grouped_int4_matmul.launches = 0         # K2, either body
grouped_int4_matmul.wg_launches = 0      # of which on the warpgroup body
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
    [T_pad, N] in x.dtype. ``fuse_quant``: quantize as the TPU kernel that
    quantizes inside itself does (K11: XLA's folded multiply by f32(1/127))
    rather than as the host quantizer (K10: a division by 127); on the card
    both run the int8 body's first pass in that arithmetic, then its main
    kernel. None means False, as in JAX. On a CPU tensor the plain version
    runs with the quantizer of the kernel it picks.
    """
    fuse_quant = bool(fuse_quant)
    if not x_sorted.is_cuda:
        return grouped_int4_matmul_a8_reference(x_sorted, tile_group_ids, qt, tile_m=tile_m,
                                                fuse_quant=fuse_quant)
    _check_a8(x_sorted, tile_group_ids, qt, tile_m)
    e, n, k = qt.shape
    dtype = x_sorted.dtype
    if dtype not in _A8_PREPASS:
        raise TypeError(f"K10/K11 take bf16 or f32 activations, got {dtype}")
    if k % 32 != 0:
        raise ValueError(f"K10/K11 need K % 32 == 0 (16-byte packed rows), got K={k}")
    _check_device_operands(x_sorted, tile_group_ids, qt)
    x_sorted = _aligned_rows(x_sorted)
    y = _launch_a8_mma(x_sorted, tile_group_ids, qt, tile_m,
                       *_a8_mma_launch(n, k, 0, _sm_count(x_sorted.device.index)),
                       fused=fuse_quant)
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
    K13 runs on the tensor-core body where K7 does
    (:func:`~.int4_matmul._k7_on_tensor_cores`: bf16 x, ``gs % 64 == 0``;
    from :data:`WG_MIN_EXPERT_ROWS` rows an expert the warpgroup body,
    :func:`_wg_body`),
    else on the CUDA-core loop; K12 on the tensor-core body for bf16 x
    (:func:`_k12_on_tensor_cores`), on the CUDA-core loop for f32 x.
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
    rows = _KERNEL_ROWS[x_sorted.dtype]
    wg = False
    if (_k12_on_tensor_cores(x_sorted.dtype) if planar
            else _k7_on_tensor_cores(x_sorted.dtype, qt.group_size)):
        _check_device_operands(x_sorted, tile_group_ids, qt)
        _check_pg_operands(x_sorted, qt, what)
        if tile_m % rows != 0:
            raise ValueError(f"{what} needs tile_m % {rows} == 0 for {x_sorted.dtype}")
        e, n, k = qt.shape
        wg = not planar and _wg_body(x_sorted.dtype, qt.granularity, qt.group_size,
                                     x_sorted.shape[0], e, tile_m, n, k)
        y = (_launch_grouped_wg(x_sorted, tile_group_ids, qt, tile_m) if wg else
             _launch_grouped_mma(x_sorted, tile_group_ids, qt, tile_m))
    else:
        y = _launch_pg(_PLANAR_PG_KERNELS if planar else _PG_KERNELS, what, x_sorted, None,
                       x_sorted, tile_group_ids, qt, tile_m, rows)
    if planar:
        grouped_int4_matmul_per_group.planar_launches += 1
    else:
        grouped_int4_matmul_per_group.launches += 1
        grouped_int4_matmul_per_group.wg_launches += wg
    return y


grouped_int4_matmul_per_group.launches = 0         # K13, any body
grouped_int4_matmul_per_group.wg_launches = 0      # of which on the warpgroup body
grouped_int4_matmul_per_group.planar_launches = 0  # K12


def grouped_int4_matmul_per_group_a8_reference(
    x_sorted: torch.Tensor, tile_group_ids: torch.Tensor, qt: QuantizedTensor,
    *, tile_m: int = 64, launch: Optional[tuple] = None,
) -> torch.Tensor:
    """Plain version of K14: the TPU wrapper's quantizer, then per expert,
    over that expert's tiles, the order of the body K14 runs
    (``int4_matmul._pg_a8_plain``: at ``gs % 32 == 0`` the int8 body's fold
    at the launch shape ``launch``, by default ``_a8_mma_launch``'s, else the
    per-run fold of ``_pg_a8_product``); x.dtype out."""
    grouped_int4_matmul_per_group_a8_reference.calls += 1
    _check_pg(x_sorted, tile_group_ids, qt, tile_m, a8=True)
    e, n, k = qt.shape
    product = _pg_a8_plain(x_sorted, n, k, qt.group_size, launch, _a8_mma_launch)
    xq, sx = _quantize_acts(x_sorted, fused=True)
    xqt, sxt = xq.reshape(-1, tile_m, k), sx.reshape(-1, tile_m, 1)
    out = torch.zeros((xqt.shape[0], tile_m, n), dtype=torch.float32, device=x_sorted.device)
    for ex in range(e):
        tiles = (tile_group_ids == ex).nonzero().flatten()
        if tiles.numel() == 0:
            continue
        y = product(xqt[tiles].reshape(-1, k), sxt[tiles].reshape(-1, 1),
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
    are quantized before the main kernel with the TPU wrapper's quantizer
    (``_quantize_acts(x, fused=True)``, see ``int4_matmul_per_group_a8``):
    at ``gs % 32 == 0`` by the int8 body's first pass, which then runs the
    per-group fold of ``_pg_a8_fold_product``; at other group sizes by the
    host quantizer, then the CUDA-core loop of ``_pg_a8_product``
    (``int4_matmul._pg_a8_on_tensor_cores`` says which, for K8 as well).
    """
    _check_pg(x_sorted, tile_group_ids, qt, tile_m, a8=True)
    if not x_sorted.is_cuda:
        return grouped_int4_matmul_per_group_a8_reference(x_sorted, tile_group_ids, qt,
                                                          tile_m=tile_m)
    if x_sorted.dtype not in _PG_A8_KERNELS:
        raise TypeError(f"K14 takes bf16 or f32 activations, got {x_sorted.dtype}")
    if _pg_a8_on_tensor_cores(qt.group_size):
        _check_device_operands(x_sorted, tile_group_ids, qt)
        _check_pg_operands(x_sorted, qt, "K14")
        e, n, k = qt.shape
        y = _launch_a8_mma(_aligned_rows(x_sorted), tile_group_ids, qt, tile_m,
                           *_a8_mma_launch(n, k, qt.group_size,
                                           _sm_count(x_sorted.device.index)), fused=True)
    else:
        xq, sx = _quantize_acts(x_sorted, fused=True)
        y = _launch_pg(_PG_A8_KERNELS, "grouped_int4_matmul_per_group_a8", xq, sx, x_sorted,
                       tile_group_ids, qt, tile_m, _A8_KERNEL_ROWS)
    grouped_int4_matmul_per_group_a8.launches += 1
    return y


grouped_int4_matmul_per_group_a8.launches = 0  # K14
