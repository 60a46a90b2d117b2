"""The int8 tensor-core body of K10 and K14 (``csrc/int8_mma.cuh``) on the CPU.

The CUDA body runs only on the card; here its arithmetic is held through its
plain versions and a model of its fragments:

* K14's plain version at each launch shape, ``_pg_a8_fold_product`` (one f32
  fold per group, in group order, slices added in a fixed order), against a
  float64 golden ``(xq * sx) @ dequant(W)^T`` and against JAX's
  ``grouped_int4_matmul_per_group_a8`` in interpret mode;
* a token row's output bits in a T=8 and a T=40 dispatch;
* the launch rule as a pure function of (N, K, gs, SMs);
* a plain-numpy model of one warp's mma.sync m16n8k32 fragments (nibble ->
  k position -> x column, as the kernel loads and permutes them), which must
  equal the plain versions bit for bit, so that a layout error shows here.

Tolerances: the fold against the float64 golden, 1e-5 of the largest output:
the fold adds 4 f32 terms per group, each rounding once (2^-24 of the running
sum), and the zero-point terms cancel most of the code terms, so the error is
a few hundred ulps of the partial sums at most (measured below 1e-6). Against
JAX, A8_TOL of tests/test_torch_per_group.py: the same quantizer and exact
integer partials, the f32 terms summed in another order (JAX adds the c.X
terms first, then the a.P terms of all groups).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.layers.moe import make_dispatch_plan as jax_make_dispatch_plan
from fused4bit_tpu.layers.moe import topk_route as jax_topk_route
from fused4bit_tpu.ops.grouped_matmul import (
    grouped_int4_matmul_per_group_a8 as jax_grouped_pg_a8,
)
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.layers import dispatch, make_dispatch_plan, topk_route
from fused4bit_tpu_torch.ops._int8 import (
    _a8_mma_launch,
    _a8_product,
    _i8_chunk,
    _pg_a8_fold_product,
)
from fused4bit_tpu_torch.ops._rows import _pg_a8_product
from fused4bit_tpu_torch.ops.int8_xla import _quantize_acts
from fused4bit_tpu_torch.quant import dequantize, quantize
from test_torch_per_group import A8_TOL, _TORCH, _jax_pg, _port_qt

GOLDEN_TOL = 1e-5


def _pg_inputs(rng, m, n, k, gs):
    w = rng.standard_normal((n, k)).astype(np.float32) * k ** -0.5
    qt = quantize(torch.from_numpy(w), granularity="per_group", layout="planar_groups",
                  group_size=gs)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32) * 2.0)
    xq, sx = _quantize_acts(x, fused=True)
    return qt, xq, sx


# --- K14's plain version: the per-group fold at each launch shape -------------


@pytest.mark.parametrize("launch", [(16, 1, 1), (8, 2, 1), (4, 2, 2), (4, 1, 4), (6, 1, 3)])
def test_pg_fold_product_matches_float64_golden(rng, launch):
    """At every split of K/2 (gs 128: two chunks per group; ws chunks per
    warp, kw warps, splits CTAs) the fold stays within GOLDEN_TOL of the
    float64 product of the same quantized operands."""
    m, n, k, gs = 24, 48, 2048, 128
    qt, xq, sx = _pg_inputs(rng, m, n, k, gs)
    y = _pg_a8_fold_product(xq, sx, qt.packed, qt.scales, qt.zero_points, launch=launch)
    golden = (xq.double() * sx.double()) @ dequantize(qt, dtype=torch.float64).t()
    err = (y.double() - golden).abs().max().item()
    assert err <= GOLDEN_TOL * golden.abs().max().item()


def test_pg_fold_product_order_is_the_launch_shapes():
    """The fold's order is its launch shape's: one split and two give
    other f32 sums, and the int32 partials are the same integers."""
    rng = np.random.default_rng(3)
    qt, xq, sx = _pg_inputs(rng, 16, 32, 1024, 64)
    one = _pg_a8_fold_product(xq, sx, qt.packed, qt.scales, qt.zero_points, launch=(8, 1, 1))
    two = _pg_a8_fold_product(xq, sx, qt.packed, qt.scales, qt.zero_points, launch=(4, 2, 1))
    again = _pg_a8_fold_product(xq, sx, qt.packed, qt.scales, qt.zero_points, launch=(8, 1, 1))
    assert torch.equal(one, again)
    assert not torch.equal(one, two)
    assert (one - two).abs().max().item() <= 1e-5 * one.abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_pg_a8_fold_matches_jax_no_closer_than_the_per_run_fold(rng, dtype):
    """K14's plain version (the wrapper on a CPU tensor) against JAX's
    grouped per-group w4a8 kernel in interpret mode, within A8_TOL, beside
    the old per-run order (``_pg_a8_product``, K8's). Neither order is JAX's
    (JAX adds the c.X terms of every group first, then the a.P terms of
    every group), and the per-group fold is not the closer one: on these
    inputs it lands 1.7e-6 from JAX against the per-run fold's 1.5e-6 in f32
    (outputs up to ~14), and 2.4e-4 against 1.2e-4 in bf16."""
    t, e, top_k, n, kdim, tile_m = 40, 4, 2, 384, 1024, 32
    bias = np.log(1.0 / (np.arange(e) + 1.0)) * 3.0
    logits = (bias[None, :] + rng.standard_normal((t, e))).astype(np.float32)
    jr = jax_topk_route(jnp.asarray(logits), top_k, e)
    jp = jax_make_dispatch_plan(jr, e, tile_m=tile_m)
    x = rng.standard_normal((t, kdim)).astype(np.float32)
    xs = np.zeros((jp.t_pad, kdim), np.float32)
    xs[np.asarray(jp.rows)] = np.repeat(x, top_k, axis=0)
    ref_qt = _jax_pg(rng.standard_normal((e, n, kdim)).astype(np.float32) * kdim ** -0.5)
    gids = np.array(jp.tile_group_ids)
    y_ref = np.asarray(jax_grouped_pg_a8(jnp.asarray(xs).astype(dtype), jnp.asarray(gids), ref_qt,
                                         tile_m=tile_m).astype(jnp.float32))
    xt = torch.from_numpy(xs).to(_TORCH[dtype])
    qt = _port_qt(ref_qt)
    before = ops.grouped_int4_matmul_per_group_a8_reference.calls
    y = ops.grouped_int4_matmul_per_group_a8(xt, torch.from_numpy(gids), qt, tile_m=tile_m)
    assert ops.grouped_int4_matmul_per_group_a8_reference.calls == before + 1
    # the same rows through the old per-run order
    xq, sx = _quantize_acts(xt, fused=True)
    old = torch.zeros((jp.t_pad, n))
    for ex in range(e):
        rows = torch.from_numpy(np.repeat(gids == ex, tile_m))
        if rows.any():
            old[rows] = _pg_a8_product(xq[rows], sx[rows], qt.packed[ex], qt.scales[ex],
                                       qt.zero_points[ex])
    bar = A8_TOL[dtype] * np.max(np.abs(y_ref))
    err_fold = np.max(np.abs(y.float().numpy() - y_ref))
    err_run = np.max(np.abs(old.to(_TORCH[dtype]).float().numpy() - y_ref))
    assert 0 < err_run < err_fold <= bar


def _dispatch_two(rng, kdim, e=4, top_k=2, tile_m=32):
    """The same 8 tokens (x and router logits) in a T=8 and a T=40 dispatch:
    (x_sorted, gids, rows of the 8 tokens' pairs) for each."""
    x40 = torch.from_numpy(rng.standard_normal((40, kdim)).astype(np.float32)).bfloat16()
    logits = torch.from_numpy(rng.standard_normal((40, e)).astype(np.float32))
    out = []
    for t in (8, 40):
        routing = topk_route(logits[:t], top_k, e)
        plan = make_dispatch_plan(routing, e, tile_m=tile_m)
        out.append((dispatch(x40[:t], routing, plan), plan.tile_group_ids, plan.rows[:8 * top_k]))
    return out


@pytest.mark.parametrize("a8_op", ["K10", "K14"])
def test_token_rows_equal_in_a_t8_and_a_t40_dispatch(rng, a8_op):
    """A token row's output bits do not depend on the T or the tile it sits
    in: the launch shape reads no T, and each row's sums run in its order."""
    e, n, kdim = 4, 64, 1024
    w = torch.from_numpy(rng.standard_normal((e, n, kdim)).astype(np.float32)) * kdim ** -0.5
    if a8_op == "K10":
        qt = quantize(w)
        op = ops.grouped_int4_matmul_a8
    else:
        qt = quantize(w, granularity="per_group", layout="planar_groups", group_size=128)
        op = ops.grouped_int4_matmul_per_group_a8
    (xs8, g8, r8), (xs40, g40, r40) = _dispatch_two(rng, kdim, e)
    assert xs40.shape[0] > xs8.shape[0]
    y8, y40 = op(xs8, g8, qt, tile_m=32), op(xs40, g40, qt, tile_m=32)
    assert torch.equal(y8[r8], y40[r40])


# --- the launch rule --------------------------------------------------------


@pytest.mark.parametrize("n, k, gs, want", [
    (14336, 4096, 0, (32, 1, 1)),      # layer2 gate/up, K10
    (4096, 14336, 0, (56, 2, 1)),      # layer2 down, K10
    (14336, 4096, 128, (32, 1, 1)),    # the same under K14, gs 128 (2 chunks a group)
    (4096, 14336, 128, (56, 2, 1)),
    (512, 256, 128, (2, 1, 1)),        # the h256 fixture's gate/up: one group per half
    (256, 512, 128, (2, 2, 1)),        # its down: two groups, two warps
    (1024, 512, 32, (1, 8, 1)),        # gs 32: chunks of 32 bytes
    (8, 4096, 0, (1, 8, 4)),           # one row tile: K split over CTAs too
])
def test_launch_rule_reads_no_t(n, k, gs, want):
    """``_a8_mma_launch`` is a pure function of (N, K, gs, SMs): no T, tile_m
    or routing reaches it. Its shape covers K/2 in whole chunks (whole groups
    for K14), kw a power of two up to 8, no split without work."""
    assert list(inspect.signature(_a8_mma_launch).parameters) == ["n", "k", "gs", "sms"]
    ws, kw, splits = _a8_mma_launch(n, k, gs, 132)
    assert (ws, kw, splits) == want
    cb = _i8_chunk(gs)
    chunks = -(-(k // 2) // cb)
    assert kw in (1, 2, 4, 8) and ws >= 1 and splits >= 1
    assert ws * kw * splits >= chunks > ws * kw * (splits - 1)
    if gs:
        assert ws % (gs // cb) == 0


# --- a plain-numpy model of the kernel's fragments ---------------------------


def _sbytes(word):
    """A uint32 word -> its 4 bytes as int8 values, byte 0 first."""
    return np.array([word], dtype="<u4").view(np.int8).astype(np.int64)


def _mma_16832(a, b):
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32 over a warp's registers:
    a [32 lanes, 4] and b [32 lanes, 2] uint32 words -> d [32, 4] int, in
    the PTX fragment layout (lane = 4g + t; a0: row g, k 4t..4t+3; a1: row
    g+8, the same k; a2, a3: k + 16; b0: column g, k 4t..; b1: k + 16; d:
    rows g, g+8 by columns 2t, 2t+1)."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for reg in range(4):
            k0 = 4 * t + 16 * (reg >> 1)
            A[g + 8 * (reg & 1), k0:k0 + 4] = _sbytes(a[lane, reg])
        for reg in range(2):
            k0 = 4 * t + 16 * reg
            B[k0:k0 + 4, g] = _sbytes(b[lane, reg])
    D = A @ B
    d = np.zeros((32, 4), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for q in range(4):
            d[lane, q] = D[g + 8 * (q >> 1), 2 * t + (q & 1)]
    return d


def _words(rows_bytes):
    """[32 lanes, R bytes] uint8 -> [32, R/4] little-endian uint32 words."""
    return np.ascontiguousarray(rows_bytes).view("<u4").astype(np.uint64)


def _lo(w):
    return w & 0x0F0F0F0F


def _hi_codes(w):
    return ((w >> 4) & 0x0F0F0F0F) ^ 0x08080808


def _hi_shifted(w):
    return w & 0xF0F0F0F0


def _model_warp(xq, packed, n0, tile, c_begin, c_end, gs, run, fold_consts):
    """One warp of the kernel: 16 weight rows from n0, the n8 tile `tile` of
    xq, chunks [c_begin, c_end) of K/2. Each lane (g, t) takes `run` bytes at
    byte run*t of each chunk of rows n0+g, n0+g+8, and the same columns of
    its row 8*tile+g of xq (low and high half), as the kernel loads them.
    K10 (gs 0): returns the int32 d fragments. K14: the f32 fold, group by
    group, with fold_consts(grp) -> (f [2 rows, 4], x [4] per lane)."""
    m, k = xq.shape
    kh = k // 2
    cb = 4 * run
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    xrows = xq.numpy().view(np.uint8)[8 * tile + g]                       # [32, K]
    pl = np.zeros((32, 4), np.int64)
    ph = np.zeros((32, 4), np.int64)
    acc = np.zeros((32, 4), np.float32)
    for c in range(c_begin, c_end):
        byte = c * cb + run * t                                           # [32]
        cols = byte[:, None] + np.arange(run)
        if gs:
            grp = c * cb // gs
            src = packed[grp]                                             # [N, gs]
            within = cols - grp * gs
            wa = _words(src[n0 + g[:, None], within])
            wb = _words(src[n0 + 8 + g[:, None], within])
        else:
            wa = _words(packed[n0 + g[:, None], cols])
            wb = _words(packed[n0 + 8 + g[:, None], cols])
        xl = _words(np.take_along_axis(xrows, cols, axis=1))
        xh = _words(np.take_along_axis(xrows, cols + kh, axis=1))
        if gs:
            for s in range(run // 8):
                a = np.stack([_lo(wa[:, 2 * s]), _lo(wb[:, 2 * s]), _lo(wa[:, 2 * s + 1]),
                              _lo(wb[:, 2 * s + 1])], axis=1)
                pl += _mma_16832(a, np.stack([xl[:, 2 * s], xl[:, 2 * s + 1]], axis=1))
                a = np.stack([_hi_shifted(wa[:, 2 * s]), _hi_shifted(wb[:, 2 * s]),
                              _hi_shifted(wa[:, 2 * s + 1]), _hi_shifted(wb[:, 2 * s + 1])],
                             axis=1)
                ph += _mma_16832(a, np.stack([xh[:, 2 * s], xh[:, 2 * s + 1]], axis=1))
            if (c + 1) % (gs // cb) == 0:
                f, x = fold_consts(grp)
                for q in range(4):
                    fr = f[q >> 1]                                        # [32, 4]
                    a = acc[:, q]
                    a = a + fr[:, 0] * pl[:, q].astype(np.float32)
                    a = a + (-fr[:, 0] * fr[:, 2]) * x[:, q & 1]
                    a = a + (fr[:, 1] * np.float32(0.0625)) * ph[:, q].astype(np.float32)
                    a = a + (fr[:, 1] * (np.float32(8.0) - fr[:, 3])) * x[:, 2 + (q & 1)]
                    acc[:, q] = a
                pl[:] = 0
                ph[:] = 0
        else:
            for s in range(run // 4):
                a = np.stack([_lo(wa[:, s]), _lo(wb[:, s]), _hi_codes(wa[:, s]),
                              _hi_codes(wb[:, s])], axis=1)
                pl += _mma_16832(a, np.stack([xl[:, s], xh[:, s]], axis=1))
    return acc if gs else pl


def _scatter(frag, out, n0, tile):
    """A warp's fragments [32, 4] into out[x row, weight row]."""
    for lane in range(32):
        g, t = divmod(lane, 4)
        for q in range(4):
            out[8 * tile + 2 * t + (q & 1), n0 + g + 8 * (q >> 1)] = frag[lane, q]


def test_fragment_model_k10_equals_the_plain_product(rng):
    """K10's fragments (low and high codes of word s in k 4t.. and 16+4t..,
    operand B the same word of the low and the high half of xq), the int32
    sums of 2 warps along K added, then JAX's epilogue: bit for bit the plain
    version ``_a8_product``."""
    m, n, k = 16, 32, 512                      # 4 chunks of 64 bytes, 2 row tiles
    qt = quantize(torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)))
    xq, sx = _quantize_acts(torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)))
    packed = qt.packed.numpy()
    acc = np.zeros((m, n), np.int64)
    for n0 in (0, 16):
        for tile in (0, 1):
            frag = sum(_model_warp(xq, packed, n0, tile, c0, c0 + 2, 0, 16, None) for c0 in (0, 2))
            _scatter(frag, acc, n0, tile)
    xsum = xq.numpy().astype(np.int64).sum(axis=1)
    s, zp, sxn = qt.scales.numpy(), qt.zero_points.numpy(), sx.numpy()[:, 0]
    yq = acc.astype(np.float32) - zp[None, :] * xsum[:, None].astype(np.float32)
    y = (s[None, :] * sxn[:, None]) * yq
    want = _a8_product(xq, sx, qt.packed, qt.scales, qt.zero_points).numpy()
    np.testing.assert_array_equal(y, want)


@pytest.mark.parametrize("gs, run", [(128, 16), (64, 16), (32, 8)])
def test_fragment_model_k14_equals_the_fold_plain_version(rng, gs, run):
    """K14's fragments (low and high halves in separate steps, words 2s,
    2s+1 of each; the high operand 16 (q - 8)), the fold per group with the
    group's constants and row sums, 2 warps along K added in order: bit for
    bit ``_pg_a8_fold_product`` at the same launch shape."""
    m, n, k = 16, 32, 1024                    # K/2 = 512: 4 groups of 128, 16 of 32
    qt, xq, sx = _pg_inputs(rng, m, n, k, gs)
    cb = 4 * run
    chunks = (k // 2) // cb
    ws = chunks // 2
    packed = qt.packed.numpy()
    scales, zps = qt.scales.numpy(), qt.zero_points.numpy()
    ng, gh = k // gs, k // gs // 2
    xsums = xq.numpy().astype(np.int64).reshape(m, ng, gs).sum(axis=-1)  # [M, 2Gh]
    acc = np.zeros((m, n), np.float32)
    for n0 in (0, 16):
        lanes = np.arange(32)
        g, t = lanes // 4, lanes % 4
        rows = [n0 + g, n0 + 8 + g]
        for tile in (0, 1):
            def consts(grp):
                f = [np.stack([scales[r, grp], scales[r, gh + grp], zps[r, grp], zps[r, gh + grp]],
                              axis=1) for r in rows]
                xr = 8 * tile + 2 * t
                x = np.stack([xsums[xr, grp], xsums[xr + 1, grp], xsums[xr, gh + grp],
                              xsums[xr + 1, gh + grp]], axis=1).astype(np.float32)
                return f, x
            parts = [_model_warp(xq, packed, n0, tile, w * ws, (w + 1) * ws, gs, run, consts)
                     for w in (0, 1)]
            _scatter(parts[0] + parts[1], acc, n0, tile)
    y = acc * sx.numpy()
    want = _pg_a8_fold_product(xq, sx, qt.packed, qt.scales, qt.zero_points,
                               launch=(ws, 2, 1)).numpy()
    np.testing.assert_array_equal(y, want)


def test_k14_body_choice_reads_the_group_size():
    """K14's body: the int8 body at gs % 32 == 0, else the CUDA-core loop
    (and its per-run plain version; test_torch_body_choice holds the
    cases); on the int8 body a chunk of a row is 64 packed bytes at gs %
    64 == 0, else 32."""
    assert [_i8_chunk(gs) for gs in (0, 32, 64, 96, 128)] == [64, 32, 64, 32, 64]
