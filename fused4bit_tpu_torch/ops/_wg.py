"""The warpgroup body of ``csrc/grouped_wgmma.cu`` for bf16 activations: the
format and shape it takes, its launch rules and its one launcher.

K2 and K13 run it over a dispatch: one CTA holds all of an expert's routed
rows for a slice of 128 output features and walks K once, so each weight
byte is streamed and dequantized once per call. K1's and K7's tall calls
run its RowScale and GroupFold instances without grouped addressing. Its
sums run in an order fixed by (N, K) (K1, K7: and the range of K each item
takes), so a row's bits do not depend on the T_pad, the tile_m or the
routing. The rows an expert (``grouped_matmul.WG_MIN_EXPERT_ROWS``) and a
linear (``int4_matmul.WG_MIN_LINEAR_ROWS``) from which a call runs it are
the families' body choices.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..quant.core import QuantizedTensor
from . import _build, _front

_ENTRIES = {"K2": "f4b_grouped_int4_matmul_wg_bf16", "K13": "f4b_grouped_int4_matmul_pg_wg_bf16",
            "K1": "f4b_int4_matmul_wg_bf16", "K7": "f4b_int4_matmul_pg_wg_bf16"}
# The body's output features per work item, a linear's rows of x per item
# and packed bytes per chunk of K/2 (kWgSlice, kLinearRows, kChunkBytes).
_WG_SLICE = 128
_WG_ROWS = 128
_WG_CHUNK = 64
_WG_MAX_SPLITS = 8
# The split rule's model of the body: a CTA's microseconds per chunk of an
# item, by the linear's kernel (its policy): K7's fitted to the launch
# timings of scripts/linear_sweep.py --pg (``launch_ms``: the body at 896 and
# 384 rows under each candidate launch; the whole-item launches read
# 1.87-1.94 at 896 rows), K1's to the whole-item launches of
# scripts/linear_sweep.py (``K1_chunk_us``: 0.82-1.00 by shape at 576 rows,
# with no fold and no X sums); per item (ring fill and epilogue: what a
# launch of more, shorter items adds); and per f32 partial element of the
# second pass (written, then read back, at ~3 TB/s of HBM). PERF.md section
# 6 has the readings; tests/test_torch_pg_linear_wg.py and
# tests/test_torch_linear_wg.py pin K7's and K1's picks to the fastest
# launches their sweeps read.
_WG_CHUNK_US = {"K1": 0.93, "K7": 1.9}
_WG_ITEM_US = 3.0
_WG_PARTIAL_US = 8 / 3.0e6


def _wg_takes(dtype: torch.dtype, group_size: int, n: int, k: int) -> bool:
    """Whether the body takes a call's format and shape: bf16 x, per row
    (``group_size`` 0) or per group with ``group_size % 64 == 0`` dividing
    K/2, N in whole slices of 128 and K/2 in whole chunks of 64 bytes."""
    kh = k // 2
    return (dtype == torch.bfloat16 and n % _WG_SLICE == 0 and kh % _WG_CHUNK == 0
            and (group_size == 0 or group_size % _WG_CHUNK == 0 and kh % group_size == 0))


def _wg_grid(e: int, n: int, sms: int) -> int:
    """The grouped body's persistent grid: a CTA per SM, at most one per
    work item (an expert's slice of 128 output features). It reads (E, N,
    SMs) only, never the routing."""
    return max(1, min(e * (n // _WG_SLICE), sms))


@functools.lru_cache(maxsize=None)
def _wg_linear_launch(m: int, n: int, k: int, sms: int, kernel: str) -> tuple:
    """The launch ``(full, splits, grid)`` of ``kernel`` (K1 or K7) on the body
    for M rows of x and an [N, K] weight on a card of ``sms`` SMs. Its items
    are (slice of 128 features, block of 128 rows): the first ``full``
    (whole slices) take all of K/2 and write y; each slice after them is cut
    into ``splits`` ranges of whole chunks (none empty), whose f32 partials
    the second pass adds in order. ``grid`` persistent CTAs take the items
    in turn.

    Whole items alone leave a ragged last wave where their count is no
    multiple of the SMs (Mixtral-8x22B's q and o at 384 rows: 144 items on
    132 SMs; Mixtral-8x7B's at 576: 160), or fall short of the card
    (K-EXAONE's k and v at 896 rows: 56; 8x7B's at 576: 40). The rule times
    each candidate by walking its items over the CTAs as the kernel does, a
    CTA's time per item that of its chunks (at the kernel's
    :data:`_WG_CHUNK_US`) plus a fixed cost, the partials' traffic added:
    all items whole, or for each ``splits`` in 2 .. :data:`_WG_MAX_SPLITS` no
    whole item or as many whole slices as fill whole waves; the least time
    wins, ties to the earlier. It reads (M, N, K, SMs) and the weights'
    format only."""
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
                           torch.clamp(chunks - z * span, max=span)]) * _WG_CHUNK_US[kernel]
        grid = min(len(costs), sms)
        costs = torch.nn.functional.pad(costs + _WG_ITEM_US, (0, -len(costs) % grid))
        t = (costs.reshape(-1, grid).sum(0).max().item()
             + (full < items) * s * m * (n - full // blocks * _WG_SLICE) * _WG_PARTIAL_US)
        if best is None or t < best[0]:
            best = (t, full, s, grid)
    return best[1:]


def _launch(x: torch.Tensor, qt: QuantizedTensor, kernel: str, *,
            gids: Optional[torch.Tensor] = None, tile_m: int = 0) -> torch.Tensor:
    """``kernel`` on the body. K1 and K7: the persistent main kernel at
    :func:`_wg_linear_launch`'s launch, then where slices are cut into ranges
    the ordered second pass. K2 and K13 over the tile map ``gids``: the first
    pass (the rows in use; K13 also the x sums of every chunk and half), then
    the persistent main kernel on :func:`_wg_grid`'s CTAs. x [M, K] checked
    and 16-byte aligned, M > 0."""
    m, k = x.shape
    n = qt.shape[-2]
    if qt.packed.data_ptr() % 16:
        raise ValueError("the warpgroup body needs 16-byte aligned packed weights")
    sms = _front._sm_count(x.device.index)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fold = (qt.group_size,) if qt.granularity == "per_group" else ()
    if gids is None:
        full, splits, grid = _wg_linear_launch(m, n, k, sms, kernel)
        tail = n - full // -(-m // _WG_ROWS) * _WG_SLICE            # features cut into ranges
        partial = (torch.empty((splits, m, tail), dtype=torch.float32, device=x.device)
                   if tail else None)
        _build.launch(x, _ENTRIES[kernel], x, qt.packed, qt.scales, qt.zero_points, y, partial,
                      m, n, k, *fold, full, splits, grid, what=kernel)
        return y
    e = qt.shape[0]
    used = torch.empty((m,), dtype=torch.int32, device=x.device)
    xsum = ((torch.empty((k // _WG_CHUNK, m), dtype=torch.float32, device=x.device),)
            if fold else ())
    _build.launch(x, _ENTRIES[kernel], x, gids, qt.packed, qt.scales, qt.zero_points, used,
                  *xsum, y, m, n, k, e, *fold, tile_m, _wg_grid(e, n, sms), what=kernel)
    return y
