"""The int8 tensor-core body of ``csrc/int8_mma.cuh``: K4 and K5 (per row)
and K8 (per group) as one-expert stacks, K10, K11 and K14 over a dispatch.
Its launch rules, its one launcher, and the plain copies of its arithmetic:
the exact per-row product (:func:`_a8_product`) and the per-group fold in
the body's order (:func:`_pg_a8_fold_product`).

A launch shape ``(ws, kw, splits)``: each warp takes a 16-row tile of output
rows and a slice of ``ws`` chunks of K/2 (whole groups per group), a CTA of 8
warps puts ``kw`` of them along K (8 / kw row tiles), and ``splits`` CTAs
cover K, an ordered second pass adding them.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..quant.core import QuantizedTensor, planar_groups_to_planar, unpack_planar
from . import _build, _front
from ._mma import _MMA_TALL_M

# the body's first pass (quantize, per-group sums, rows in use)
_A8_PREPASS = {torch.bfloat16: "f4b_a8_prepass_bf16", torch.float32: "f4b_a8_prepass_f32"}
_I8_WARPS = 8        # warps per CTA of the int8 body
# SM count the plain versions of K8 and K14 assume for CPU tensors: the
# H100's (the launch rule, and so their order of f32 sums, depends on it)
_PLAIN_SMS = 132


def _i8_chunk(gs: int) -> int:
    """Packed bytes per chunk of a row in the int8 body: 4 lanes x 16 bytes,
    or x 8 for K8 and K14 at ``gs % 64 != 0``. ``gs`` 0 means per row (K10)."""
    return 64 if gs % 64 == 0 else 32


def _a8_mma_launch(n: int, k: int, gs: int, sms: int) -> tuple:
    """The launch shape of K10, K11 and K14 on an [N, K] expert weight
    (``gs`` its group size, 0 per row) on a card of ``sms`` SMs.

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
    """K8's launch shape ``(ws, kw, 1)`` for an [N, K] weight per group of
    ``gs`` (gs % 32 == 0; 0 per row, K5's decode shape, where one 64-byte
    chunk stands in for a group) on a card of ``sms`` SMs: the fewest warps
    along K, a power of two up to 8 and up to K/2's groups, that give every
    SM a CTA of 8 warps from one block of 16 rows (a decode step), each warp
    on whole groups; K is never split across CTAs. At the layer2 linears
    that is (4, 8, 1) at q/o (N=4096) and k/v (1024), (8, 4, 1) at the
    lm_head (8192): at 8 rows they measured 0.0170, 0.0155 and 0.0222 ms on
    the H100 against 0.0235, 0.0155 and 0.0362 at :func:`_a8_mma_launch`'s
    shapes, which keep two warps per SM, and 15-18 % slower at 640 rows
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
    """K5's and K4's launch shape for an [N, K] per-row weight and M rows of
    x on a card of ``sms`` SMs: K8's decode rule :func:`_linear_a8_launch`
    (per row, one CTA of 8 warps per SM from one block of 16 rows, no split)
    up to :data:`~._mma._MMA_TALL_M` rows, the grouped rule
    :func:`_a8_mma_launch` (two warps per SM from one block of rows) above
    it, where K8's decode shape measured 15-18 % slower at 640 rows.

    Unlike the other launch rules it reads M. That is safe because K5's and
    K4's sums are exact int32 (as K10's): their output bits are the same at
    every launch shape, so a row's bits do not depend on the rows beside
    it."""
    if m > _MMA_TALL_M:
        return _a8_mma_launch(n, k, 0, sms)
    return _linear_a8_launch(n, k, 0, sms)


def _rule(kernel: str, m: int, n: int, k: int, gs: int, sms: int) -> tuple:
    """``kernel``'s launch shape on the body: K4's and K5's
    :func:`_row_a8_launch`, K8's :func:`_linear_a8_launch` (neither reads
    ``m``), K10's, K11's and K14's :func:`_a8_mma_launch`."""
    if kernel in ("K4", "K5"):
        return _row_a8_launch(n, k, m, sms)
    if kernel == "K8":
        return _linear_a8_launch(n, k, gs, sms)
    return _a8_mma_launch(n, k, gs, sms)


def _launch(x: torch.Tensor, qt: QuantizedTensor, kernel: str, *,
            gids: Optional[torch.Tensor] = None, tile_m: int = 0,
            launch: Optional[tuple] = None) -> torch.Tensor:
    """``kernel`` on the body at ``launch`` (by default its :func:`_rule`'s):
    its first pass (quantize, per-group sums, which rows hold a nonzero), the
    main kernel and, with splits > 1, the ordered second pass; a linear as a
    one-expert stack (``gids`` None: any M). The first pass's quantizer:
    XLA's multiply by f32(1/127) (K5, K8, K11, K14), else the host
    quantizer's division by 127 (K4, K10); see
    :func:`~.int8_xla._quantize_acts`. x [M, K] checked and 16-byte aligned,
    M > 0."""
    n, k = qt.shape[-2:]
    m = x.shape[0]
    gs = qt.group_size
    ws, kw, splits = launch or _rule(kernel, m, n, k, gs, _front._sm_count(x.device.index))
    gsum = gs or k // 2
    dev = x.device
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    sums = torch.empty((m, k // gsum), dtype=torch.int32, device=dev)
    used = torch.empty((m,), dtype=torch.int32, device=dev)
    partial = (torch.empty((splits, m, n), dtype=torch.float32 if gs else torch.int32,
                           device=dev) if splits > 1 else None)
    _build.launch(x, _A8_PREPASS[x.dtype], x, xq, sx, sums, used, m, k, gsum,
                  int(kernel not in ("K4", "K10")), what=f"{kernel}: the int8 body's first pass")
    main = "f4b_grouped_int4_matmul_pg_a8_mma" if gs else "f4b_grouped_int4_matmul_a8_mma"
    _build.launch(x, main, xq, sx, sums, used, gids, qt.packed, qt.scales, qt.zero_points, y,
                  partial, m, n, k, *((gs,) if gs else ()), tile_m, int(x.dtype == torch.float32),
                  ws, kw, splits, what=kernel)
    return y


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


def _fold_plain(x: torch.Tensor, kernel: str, n: int, k: int, gs: int,
                launch: Optional[tuple]):
    """The plain product of K8 or K14 on the body, ``(xq, sx, packed3,
    scales, zero_points) -> f32``: :func:`_pg_a8_fold_product` at
    ``launch``, by default ``kernel``'s :func:`_rule` on x's card, or on an
    H100's 132 SMs for a CPU tensor."""
    sms = _front._sm_count(x.device.index) if x.is_cuda else _PLAIN_SMS
    return functools.partial(_pg_a8_fold_product, launch=launch or _rule(kernel, 0, n, k, gs, sms))
