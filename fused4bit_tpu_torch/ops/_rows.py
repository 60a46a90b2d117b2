"""The CUDA-core loops of ``csrc/int4_rows.cuh`` and ``csrc/int4_rows_pg.cuh``:
f32 activations (an f32 tensor-core product would be TF32) of K1, K2, K6, K9
and K12, the group sizes off 64 of K7 and K13, and those off 32 of K8 and
K14, whose activations the host quantizer quantizes first. Their one
launcher, K9's split of K, and the plain copy of K8's and K14's order of
sums there (:func:`_pg_a8_product`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..quant.core import QuantizedTensor, planar_groups_to_planar, unpack_planar
from ..quant.reference import full_precision
from . import _build, _front
from .int8_xla import _quantize_acts

# each kernel's entry points, the activations' type (_bf16, _f32) appended
_ENTRIES = {
    "K1": "f4b_int4_matmul",
    "K6": "f4b_int4_matmul_planar_pg",
    "K7": "f4b_int4_matmul_pg",
    "K8": "f4b_int4_matmul_pg_a8",
    "K2": "f4b_grouped_int4_matmul",
    "K9": "f4b_grouped_int4_matmul_ksplit",
    "K12": "f4b_grouped_int4_matmul_planar_pg",
    "K13": "f4b_grouped_int4_matmul_pg",
    "K14": "f4b_grouped_int4_matmul_pg_a8",
}
# x rows per CTA of K14's loop (K2, K9, K12 and K13: _front._KERNEL_ROWS)
_A8_KERNEL_ROWS = 16
_CHUNK = 512   # packed bytes per chunk of the loop (f32 K9)
_LANES = 32    # lanes of a warp, each over its own runs of 16 packed bytes
_RUN = 16


def _ksplit_splits(t_pad: int, n: int, k: int, rows: int, sms: int) -> int:
    """f32 K9's number of K splits for a [t_pad, K] x [N, K] product
    (``rows`` x rows per CTA) on a card of ``sms`` SMs: enough CTAs (32
    output rows x one block of rows each) for one per SM, between 1 and the
    chunks of K/2 (1 at every layer2 shape: the grid fills the card
    already)."""
    ctas = -(-n // 32) * -(-t_pad // rows)
    return max(1, min(-(-(k // 2) // _CHUNK), -(-sms // ctas)))


def _launch(x: torch.Tensor, qt: QuantizedTensor, kernel: str, *,
            gids: Optional[torch.Tensor] = None, tile_m: int = 0) -> torch.Tensor:
    """``kernel`` on its loop (a grouped one over the tile map ``gids``,
    skipping each block's zero padding rows; K9 split over K,
    :func:`_ksplit_splits`); K8 and K14 on x quantized by the host quantizer
    (``_quantize_acts(x, fused=True)``). x [M, K] checked and 16-byte
    aligned, M > 0."""
    m, k = x.shape
    n = qt.shape[-2]
    entry = f"{_ENTRIES[kernel]}_{'f32' if x.dtype == torch.float32 else 'bf16'}"
    gs = (qt.group_size,) if qt.granularity == "per_group" else ()
    head = _quantize_acts(x, fused=True) if kernel in ("K8", "K14") else (x,)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if gids is None:
        _build.launch(x, entry, *head, qt.packed, qt.scales, qt.zero_points, y, m, n, k, *gs,
                      what=kernel)
        return y
    rows = _A8_KERNEL_ROWS if kernel == "K14" else _front._KERNEL_ROWS[x.dtype]
    # scratch: rows in use per block of kernel rows (the zero padding is skipped)
    used = torch.empty((-(-m // rows),), dtype=torch.int32, device=x.device)
    weights = (gids, qt.packed, qt.scales, qt.zero_points, used)
    if kernel == "K9":
        splits = _ksplit_splits(m, n, k, rows, _front._sm_count(x.device.index))
        partial = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
        _build.launch(x, entry, x, *weights, partial, y, m, n, k, tile_m, splits, what=kernel)
    else:
        _build.launch(x, entry, *head, *weights, y, m, n, k, *gs, tile_m, what=kernel)
    return y


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
