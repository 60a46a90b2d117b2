"""The tensor-core body of ``csrc/int4_mma.cuh`` for bf16 activations: K1, K6
and K7 as linears, K2, K9, K12 and K13 with grouped addressing. Its launch
rules, its tile and its one launcher.

A launch shape ``(ws, kw, splits)``: each warp takes a 16-row tile of output
rows and ``ws`` k steps of 16 columns, a CTA of 8 warps puts ``kw`` of them
along K (8 / kw row tiles), and ``splits`` CTAs cover K, an ordered second
pass adding their f32 partials. The decode rules read (N, K, SMs) only: a
row's sums then run in the same order at every M up to :data:`_MMA_TALL_M`
(a linear), and wherever a token row sits in a dispatch up to tile_m 64 (a
grouped call), so its output bits do not depend on the rows beside it, the
tile, the T or the routing. At tile_m 128, the prefill's, a grouped call
takes 64-row tiles whose launch may read T; K9 keeps its own launch there
too.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..quant.core import QuantizedTensor
from . import _build, _front

_ENTRIES = {
    "K1": "f4b_int4_matmul_bf16",
    "K6": "f4b_int4_matmul_planar_pg_bf16",
    "K7": "f4b_int4_matmul_pg_mma_bf16",
    "K2": "f4b_grouped_int4_matmul_mma_bf16",
    "K9": "f4b_grouped_int4_matmul_mma_bf16",
    "K12": "f4b_grouped_int4_matmul_planar_pg_mma_bf16",
    "K13": "f4b_grouped_int4_matmul_pg_mma_bf16",
}
# K7 and K13 (GroupFold) run the body at group sizes that are multiples of
# this: a chunk of 64 packed bytes (8 k steps) never straddles two groups
_FOLD_GS = 64
_MMA_TALL_M = 64      # above this many rows of x, the prefill tile (64 rows per CTA)


def _mma_launch(n: int, k: int, sms: int) -> tuple:
    """The decode launch shape ``(ws, kw, splits)`` of K1 and K6 for an
    [N, K] weight on a card of ``sms`` SMs.

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
    """K7's decode launch shape: :func:`_mma_launch`'s rule with whole chunks
    of 8 k steps per warp (``ws`` in 32, 16, 8), so that each warp folds the
    partial sums of whole chunks, each of one group (gs % 64 == 0). It reads
    (N, K, SMs) only, as :func:`_mma_launch` does; at every layer2 shape the
    two give the same shape."""
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
    """The prefill launch shape ``(ws, 1, splits)`` of the tall tile: a CTA
    takes 8 row tiles and 64 rows of x and walks its range of K in stages of
    32 k steps; K is split across CTAs only as far as it takes to give every
    SM a CTA (k and v at N=1024, the router at N=8), in whole stages."""
    stages = -(-(k // 2) // 256)                      # 32 k steps (256 packed bytes) each
    ctas = -(-n // 128) * -(-m // 64)
    ws = 32 * -(-stages // min(stages, -(-sms // ctas)))
    return ws, 1, -(-32 * stages // ws)


def _grouped_mma_launch(n: int, k: int, sms: int) -> tuple:
    """The launch shape of K2, K12 and K13 at tile_m <= 64 for an [N, K]
    expert weight on a card of ``sms`` SMs, each warp on whole chunks of 64
    packed bytes (8 k steps each, so K13 folds whole chunks).

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
    """K9's launch shape ``(ws, 1, splits)`` for an [N, K] expert weight on a
    card of ``sms`` SMs, at every tile_m (the 64-row tile at tile_m 128 as
    well).

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


def _tile_rows(m: int, tile_m: int = 0) -> int:
    """Rows of x per CTA: the tall tile's :data:`_MMA_TALL_M` for a linear
    (``tile_m`` 0) above that many rows, or a grouped call at a tile_m that
    is a multiple of it above it (the prefill's tiles); else the decode
    tile's 16."""
    if tile_m:
        tall = tile_m > _MMA_TALL_M and tile_m % _MMA_TALL_M == 0
    else:
        tall = m > _MMA_TALL_M
    return _MMA_TALL_M if tall else 16


def _launch(x: torch.Tensor, qt: QuantizedTensor, kernel: str, *,
            gids: Optional[torch.Tensor] = None, tile_m: int = 0,
            launch: Optional[tuple] = None) -> torch.Tensor:
    """``kernel`` on the body (a grouped one over the tile map ``gids`` with
    its first pass, which marks the rows that hold a nonzero), on
    :func:`_tile_rows`' tile at ``launch``, by default the kernel's rule:
    K9's :func:`_ksplit_mma_launch` at every tile; else the tall tile's
    :func:`_mma_tall_launch`, or the decode tile's :func:`_grouped_mma_launch`
    (K2, K12, K13), :func:`_fold_mma_launch` (K7) or :func:`_mma_launch`
    (K1, K6). x [M, K] checked and 16-byte aligned, M > 0."""
    m, k = x.shape
    n = qt.shape[-2]
    sms = _front._sm_count(x.device.index)
    rows = _tile_rows(m, tile_m)
    if launch is None:
        if kernel == "K9":
            launch = _ksplit_mma_launch(n, k, sms)
        elif rows == _MMA_TALL_M:
            launch = _mma_tall_launch(n, k, m, sms)
        elif gids is not None:
            launch = _grouped_mma_launch(n, k, sms)
        else:
            launch = (_fold_mma_launch if kernel == "K7" else _mma_launch)(n, k, sms)
    ws, kw, splits = launch
    gs = (qt.group_size,) if qt.granularity == "per_group" else ()
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    if gids is None:
        _build.launch(x, _ENTRIES[kernel], x, qt.packed, qt.scales, qt.zero_points, y, partial,
                      m, n, k, *gs, ws, kw, splits, rows, what=kernel)
    else:
        used = torch.empty((m,), dtype=torch.int32, device=x.device)
        _build.launch(x, _ENTRIES[kernel], x, gids, qt.packed, qt.scales, qt.zero_points, used,
                      y, partial, m, n, k, *gs, tile_m, ws, kw, splits, rows, what=kernel)
    return y
