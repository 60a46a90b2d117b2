"""K2, K9, K12 and K13 on the tensor-core body (``csrc/int4_mma.cuh`` with
grouped addressing), in what the CPU can check: the launch rules as pure
functions of (N, K, SMs), the body choice, and a plain-torch model of the
grouped body held against the JAX package's ``grouped_int4_matmul`` (K2, and
K9 at its own launch against ``mode="ksplit"``) and
``grouped_int4_matmul_per_group`` (K13 on planar_groups bytes, K12 on planar
ones) in interpret mode on the same bytes.

The model repeats the body's arithmetic where it is fixed: per tile, the
expert's weights; per warp, its chunks of 64 packed bytes in the order it
walks them (stages of up to 32 k steps, the CTA's kw warps taking kw
consecutive runs of each stage); K1's arithmetic (RowScale: the dot of x
with q - zp, the scale on the f32 sum), K6's (GroupDequant: the dot of x with
the weight dequantized to the compute type, ``bf16(bf16(s) * (q - zp))`` in
bf16) or K7's fold per chunk (GroupFold,
``test_torch_pg_mma``'s ``acc += s_lo*P_lo; acc += c_lo*X_lo; acc +=
s_hi*P_hi; acc += c_hi*X_hi``); the warps of a CTA added in order, then the
CTAs along K; the rows after a block's last row in use written as 0. Where it
is not fixed (the order in which the tensor cores sum a 16-wide step, the
FMA's single rounding), the model sums each chunk exactly and rounds once.

Tolerances: against JAX, 1e-3 of the largest output in f32 and 2e-2 in bf16,
the bars of ``test_torch_pg_mma.py`` (one bf16 rounding of each side, and
the f32 sums in another order).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.layers.moe import make_dispatch_plan as jax_make_dispatch_plan
from fused4bit_tpu.layers.moe import topk_route as jax_topk_route
from fused4bit_tpu.ops.grouped_matmul import grouped_int4_matmul as jax_grouped
from fused4bit_tpu.ops.grouped_matmul import grouped_int4_matmul_per_group as jax_grouped_pg
from fused4bit_tpu.quant.core import quantize as jax_quantize
from fused4bit_tpu_torch.ops import _build, _mma, _rows, _wg
from fused4bit_tpu_torch.ops import grouped_matmul as gm
from fused4bit_tpu_torch.ops._mma import _MMA_TALL_M, _fold_mma_launch, _mma_launch
from fused4bit_tpu_torch.ops.int4_matmul import planar_pg_weight
from fused4bit_tpu_torch.quant import planar_groups_to_planar, quantize, unpack_planar
from test_torch_pg_mma import CHUNK, SMS, _chunk_sums

STAGE = 32   # k steps a warp holds per stage
STEPS = 8    # k steps per chunk
TOL = {"float32": 1e-3, "bfloat16": 2e-2}

# The grouped linears of `layer2` (8 experts, gate/up 14336 x 4096, down
# 4096 x 14336) and of the trained h256 fixture (4 experts, 512 x 256 and
# 256 x 512), and the tests' own 384 x 512.
SHAPES = [(14336, 4096), (4096, 14336), (512, 256), (256, 512), (384, 512)]


def warp_chunks(launch: tuple, chunks: int) -> list:
    """The chunks each warp folds, in its order: [split][warp] -> chunk ids.
    Stage o (of 32 k steps) of split z: the CTA's steps from z*kw*ws +
    o*kw, warp w taking the run of len steps at w*len."""
    ws, kw, splits = launch
    assert ws % STEPS == 0, "the grouped body walks whole chunks"
    steps = chunks * STEPS
    out = []
    for z in range(splits):
        cs, ce = z * kw * ws, min(steps, (z + 1) * kw * ws)
        per_warp = []
        for w in range(kw):
            mine = []
            for o in range(0, ws, STAGE):
                ln = min(STAGE, ws - o)
                wa = min(cs + o * kw + w * ln, ce)
                wb = min(wa + ln, ce)
                mine += range(wa // STEPS, wb // STEPS)
            per_warp.append(mine)
        out.append(per_warp)
    return out


def body_model(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, zps: torch.Tensor,
               launch: tuple, gs: int = 0, dequant=None) -> torch.Tensor:
    """One expert's rows through the body, f32 out: x [M, K] (its values as
    the kernel stages them); per row (gs 0) planar bytes [N, K/2] and
    scales/zero points [N]; per group planar_groups bytes [Gh, N, gs] and
    [N, 2Gh] (K13's fold), or with ``dequant`` (K12) planar bytes [N, K/2]
    and [N, 2Gh], the weight dequantized to the compute type ``dequant``."""
    m, k = x.shape
    kh = k // 2
    chunks = kh // CHUNK
    xd = x.double()
    s, z = scales.float(), zps.float()
    fold = gs and dequant is None
    if dequant is not None:  # GroupDequant: K6's weight, exact in float64
        w = planar_pg_weight(packed, scales, zps, gs, dequant).double()
    elif gs:
        codes = unpack_planar(planar_groups_to_planar(packed)).double()  # [N, K]
        gh = kh // gs
        q_lo, q_hi = codes[:, :kh], codes[:, kh:] - 8.0                  # the raw codes
        x_lo, x_hi = _chunk_sums(x[:, :kh]), _chunk_sums(x[:, kh:])      # [M, chunks]
    else:
        w = unpack_planar(packed).double() - z.double()[:, None]         # q - zp, exact

    def chunk(acc, c):
        cols = slice(c * CHUNK, (c + 1) * CHUNK)
        hcols = slice(kh + c * CHUNK, kh + (c + 1) * CHUNK)
        if not fold:  # RowScale, GroupDequant: the chunk's dot, exact, rounded once
            return acc + (xd[:, cols] @ w[:, cols].t() + xd[:, hcols] @ w[:, hcols].t()).float()
        g = c * CHUNK // gs
        p_lo = (xd[:, cols] @ q_lo[:, cols].t()).float()
        p_hi = (xd[:, hcols] @ q_hi[:, cols].t()).float()
        s_lo, s_hi = s[:, g], s[:, gh + g]
        acc = acc + s_lo * p_lo
        acc = acc + ((-s_lo) * z[:, g]) * x_lo[:, c:c + 1]
        acc = acc + s_hi * p_hi
        return acc + (s_hi * (8.0 - z[:, gh + g])) * x_hi[:, c:c + 1]

    y = torch.zeros((m, s.shape[0]))
    for per_warp in warp_chunks(launch, chunks):          # CTAs along K, in order
        cta = torch.zeros_like(y)
        for mine in per_warp:                             # the CTA's warps, in order
            acc = torch.zeros_like(y)
            for c in mine:
                acc = chunk(acc, c)
            cta = cta + acc
        y = y + cta
    return y if gs else s[None, :] * y


def grouped_model(xs: torch.Tensor, gids: torch.Tensor, packed, scales, zps, tile_m: int,
                  launch: tuple, gs: int = 0, dequant=None) -> torch.Tensor:
    """K2 (gs 0), K13 or (``dequant``) K12 over a dispatch, f32 out: per
    block of 16 rows (one tile's, tile_m % 16 == 0), its expert's weights,
    up to its last row that holds a nonzero; the rows after it 0."""
    out = torch.zeros((xs.shape[0], packed.shape[-2]))
    for b0 in range(0, xs.shape[0], 16):
        rows = xs[b0:b0 + 16]
        nonzero = (rows != 0).any(dim=1).nonzero()
        if nonzero.numel() == 0:
            continue
        used = int(nonzero.max()) + 1
        e = int(gids[b0 // tile_m])
        out[b0:b0 + used] = body_model(rows[:used], packed[e], scales[e], zps[e], launch, gs,
                                       dequant)
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _dispatch(rng, t, e, kdim, tile_m, logits=None):
    """JAX's routing and dispatch plan of t tokens (top-2, skewed) and the
    sorted rows, zero padded: (x_sorted [T_pad, K] f32, gids, rows of the
    tokens' pairs)."""
    if logits is None:
        bias = np.log(1.0 / (np.arange(e) + 1.0)) * 3.0
        logits = (bias[None, :] + rng.standard_normal((t, e))).astype(np.float32)
    plan = jax_make_dispatch_plan(jax_topk_route(jnp.asarray(logits[:t]), 2, e), e, tile_m=tile_m)
    return np.array(plan.tile_group_ids), np.array(plan.rows), plan.t_pad


def _sorted(x, rows, t_pad):
    xs = np.zeros((t_pad, x.shape[1]), np.float32)
    xs[rows] = np.repeat(x, 2, axis=0)
    return xs


# --- the launch rule and the body choice --------------------------------------


def test_grouped_launch_reads_n_k_and_sms_only():
    """No T, tile_m or routing among the rules' inputs (K2, K12, K13; K9):
    a token row's sums run in one order in every dispatch at tile_m up to
    64 (K9: at every tile_m), so its bits do not depend on the T, the tile
    or the tile_m it sits in."""
    for rule in (_mma._grouped_mma_launch, _mma._ksplit_mma_launch):
        assert list(inspect.signature(rule).parameters) == ["n", "k", "sms"]
    assert _MMA_TALL_M == 64


@pytest.mark.parametrize("n,k", SHAPES)
def test_grouped_launch_covers_k_in_whole_chunks(n, k):
    """Whole chunks per warp (K13 folds whole chunks), a launch the body
    takes (kw a power of two up to 8, ws a multiple of 8), every chunk of
    K/2 walked exactly once in each warp's order, no CTA beyond K; at the
    layer2 shapes every CTA's range is whole groups of 128 (16 k steps), and
    every SM gets two warps from one block of 16 rows."""
    ws, kw, splits = _mma._grouped_mma_launch(n, k, SMS)
    chunks = (k // 2) // CHUNK
    assert ws % STEPS == 0 and kw in (1, 2, 4, 8) and splits >= 1
    assert (splits - 1) * kw * ws < chunks * STEPS <= splits * kw * ws
    walked = [c for per_warp in warp_chunks((ws, kw, splits), chunks) for mine in per_warp
              for c in mine]
    assert sorted(walked) == list(range(chunks))
    if k >= 4096:
        assert (kw * ws) % 16 == 0
        assert -(-n // 16) * kw * splits >= 2 * SMS


@pytest.mark.parametrize("n,k", SHAPES + [(64, 1024), (64, 128)])
def test_ksplit_launch_splits_k_across_ctas(n, k):
    """K9's launch: whole chunks per warp in a launch the body takes, every
    chunk of K/2 walked once, no CTA beyond K, and K split across at least
    two CTAs wherever K/2 holds two chunks (K=128: one chunk, one CTA), with
    at least as many slices of K as K2's rule takes."""
    launch = ws, kw, splits = _mma._ksplit_mma_launch(n, k, SMS)
    chunks = (k // 2) // CHUNK
    assert ws % STEPS == 0 and kw in (1, 2, 4, 8) and splits >= 1
    assert (splits - 1) * kw * ws < chunks * STEPS <= splits * kw * ws
    walked = [c for per_warp in warp_chunks(launch, chunks) for mine in per_warp for c in mine]
    assert sorted(walked) == list(range(chunks))
    assert splits >= 2 if chunks >= 2 else splits == 1
    k2_ws, k2_kw, k2_splits = _mma._grouped_mma_launch(n, k, SMS)
    assert kw * splits >= min(chunks, k2_kw * k2_splits)


def test_body_choice_reads_dtype_and_group_size_only():
    """K13 takes the tensor-core body where K7 does, by the operands' format
    alone (bf16 x, gs % 64 == 0); K2 and K12 take it for bf16 x (K12 at every
    planar group size, gs % 128 == 0), f32 x keeps the CUDA-core loop, which
    K12 has in f32 alone (test_torch_body_choice holds the cases). Each
    kernel's entry points on the two bodies."""
    assert _mma._ENTRIES["K2"] == _mma._ENTRIES["K9"] == "f4b_grouped_int4_matmul_mma_bf16"
    assert _mma._ENTRIES["K13"] == "f4b_grouped_int4_matmul_pg_mma_bf16"
    assert _mma._ENTRIES["K12"] == "f4b_grouped_int4_matmul_planar_pg_mma_bf16"
    for kernel, dtypes in (("K2", ["f32"]), ("K9", ["f32"]), ("K12", ["f32"]),
                           ("K13", ["bf16", "f32"]), ("K14", ["bf16", "f32"])):
        assert [d for d in ("bf16", "f32")
                if f"{_rows._ENTRIES[kernel]}_{d}" in _build._SIGNATURES] == dtypes


# --- the warpgroup body (csrc/grouped_wgmma.cu) --------------------------------

# The benchmark cells' expert widths (Mixtral-8x22B per group of 128: K13;
# Mixtral-8x7B per row: K2), the layer2 ones and the trained h256 fixture's.
WG_SHAPES = [(16384, 6144), (6144, 16384), (14336, 4096), (4096, 14336), (512, 256), (256, 512)]


def _t_pad(t, e, tile_m, top_k=2):
    """T_pad of a dropless dispatch of t tokens (the port's own plan)."""
    from fused4bit_tpu_torch.layers import make_dispatch_plan, topk_route

    routing = topk_route(torch.randn((t, e), generator=torch.Generator().manual_seed(t)), top_k, e)
    return make_dispatch_plan(routing, e, tile_m=tile_m).t_pad


def test_wg_body_choice_reads_shape_and_format_only():
    """The body choice reads the kernel, device, dtype, group size, T_pad, E,
    tile_m, N and K, never the tile map's contents, the rows' or the
    routing (test_torch_body_choice holds the cases: the cells' calls take
    the warpgroup body, Mixtral-8x22B's K13 at 384 tokens, T_pad 896 at
    tile_m 16, and Mixtral-8x7B's K2 at 576, T_pad 2176 at tile_m 128;
    decode and the verify keep the old body). Each kernel's entry point."""
    params = list(inspect.signature(gm._body).parameters)
    assert set(params) <= {"kernel", "cuda", "dtype", "group_size", "t_pad", "e", "tile_m", "n",
                           "k"}
    assert _t_pad(384, 8, 16) == 896 and _t_pad(576, 8, 128) == 2176
    assert 8 * gm.WG_MIN_EXPERT_ROWS <= 896 - 8 * 16
    assert _wg._ENTRIES == {"K2": "f4b_grouped_int4_matmul_wg_bf16",
                            "K13": "f4b_grouped_int4_matmul_pg_wg_bf16",
                            "K1": "f4b_int4_matmul_wg_bf16",
                            "K7": "f4b_int4_matmul_pg_wg_bf16"}


@pytest.mark.parametrize("n,k", WG_SHAPES)
def test_wg_launch_covers_k_in_whole_chunks_and_n_in_whole_slices(n, k):
    """At the cells', layer2's and the h256 fixture's widths the body takes
    the call; its persistent grid (E, N and SMs only, a CTA per SM at most)
    walks every (expert, slice of 128 features) item exactly once, and each
    item walks K/2 in whole chunks of 64 bytes (whole groups of 128 in K13)."""
    for kernel, gs in (("K2", 0), ("K13", 128)):
        assert gm._body(kernel, True, torch.bfloat16, gs, 4096, 8, 16, n, k) == "wg"
    assert list(inspect.signature(_wg._wg_grid).parameters) == ["e", "n", "sms"]
    for e in (4, 8):
        grid = _wg._wg_grid(e, n, SMS)
        items = e * n // _wg._WG_SLICE
        assert 1 <= grid <= min(SMS, items)
        walked = sorted(i for cta in range(grid) for i in range(cta, items, grid))
        assert walked == list(range(items))
        covered = sorted((i // (n // _wg._WG_SLICE), (i % (n // _wg._WG_SLICE)) * _wg._WG_SLICE + f)
                         for i in walked for f in range(_wg._WG_SLICE))
        assert covered == [(ex, f) for ex in range(e) for f in range(n)]
    chunks = (k // 2) // _wg._WG_CHUNK
    assert chunks * _wg._WG_CHUNK == k // 2 and (chunks * _wg._WG_CHUNK) % 128 == 0


def _family_rules():
    """The benchmark's kernel-family rules of the expert and linear rooflines."""
    import importlib.util
    import pathlib

    rules = {}
    for name in ("grouped_matmul_roofline", "int4_matmul_roofline"):
        path = pathlib.Path(__file__).resolve().parents[1] / "portbench" / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        rules[name] = mod._main
    return rules


@pytest.mark.parametrize("policy", ["RowScale", "GroupFold"])
def test_wg_kernel_symbols_fall_in_the_grouped_family(policy):
    """The warpgroup body's main kernel, mangled (as nvcc names it in an
    anonymous namespace) and demangled (as the profiler may give it), is an
    ``int4_mma_kernel`` instantiation with the grouped flag true: the
    benchmark counts it, and its first passes, among the expert kernels and
    not among the linears."""
    from portbench import trace

    from fused4bit_tpu_torch.ops import _build

    assert {"int4_mma_kernel_wg", "fold_rows_used_kernel"} <= set(trace.csrc_kernels(_build.CSRC))
    ns = "_ZN3f4b49_GLOBAL__N__3a36cd68_16_grouped_wgmma_cu_f47962b8"
    mangled = (f"{ns}18int4_mma_kernel_wgINS0_{len(policy)}{policy}ELb1EEEv14CUtensorMap_stS3_"
               "NS0_6WgArgsE")
    anon = "f4b::(anonymous namespace)::"
    demangled = (f"void {anon}int4_mma_kernel_wg<{anon}{policy}, true>(CUtensorMap_st, "
                 f"CUtensorMap_st, {anon}WgArgs)")
    rules = _family_rules()
    for name in (mangled, demangled):
        assert trace.grouped_flag(name) is True
        assert rules["grouped_matmul_roofline"](name)
        assert not rules["int4_matmul_roofline"](name)
    for first in (f"{ns}21fold_rows_used_kernelEPK13__nv_bfloat16iiPiPf",
                  f"void {anon}fold_rows_used_kernel(__nv_bfloat16 const*, int, int, int*, float*)"):
        assert rules["grouped_matmul_roofline"](first) and not rules["int4_matmul_roofline"](first)


WG_TILES = (16, 32, 64, 128)


def _wg_launch(k):
    """The warpgroup body's walk in the model's terms: one warp, all of K/2
    in chunk order, no split."""
    return (8 * ((k // 2) // CHUNK), 1, 1)


def wg_model(xs, gids, packed, scales, zps, tile_m, gs=0):
    """The warpgroup body over a dispatch, f32 out: per run of consecutive
    tiles of one expert, its rows up to the run's last row that holds a
    nonzero through the expert's weights, all of K in chunk order (the fold
    per chunk in K13); the rows after it 0."""
    out = torch.zeros((xs.shape[0], packed.shape[-2]))
    tiles = gids.shape[0]
    t = 0
    while t < tiles:
        end = t
        while end < tiles and int(gids[end]) == int(gids[t]):
            end += 1
        r0, r1 = t * tile_m, end * tile_m
        nonzero = (xs[r0:r1] != 0).any(dim=1).nonzero()
        if nonzero.numel():
            used = int(nonzero.max()) + 1
            e = int(gids[t])
            out[r0:r0 + used] = body_model(xs[r0:r0 + used], packed[e], scales[e], zps[e],
                                           _wg_launch(xs.shape[1]), gs)
        t = end
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["K2", "K13"])
def test_wg_model_matches_jax_kernel(rng, kernel, dtype):
    """The warpgroup body's model (whole K per expert in chunk order, K13's
    fold per chunk) against JAX's grouped kernels in interpret mode on the
    same bytes and dispatch at tile_m 16 and 128, with the zero padding rows
    exactly 0."""
    w = rng.standard_normal((E, N, KDIM)).astype(np.float32) * KDIM ** -0.5
    gs = 128 if kernel == "K13" else 0
    ref_qt = (jax_quantize(jnp.asarray(w), granularity="per_group", layout="planar_groups",
                           group_size=gs) if gs else jax_quantize(jnp.asarray(w)))
    op = jax_grouped_pg if gs else jax_grouped
    for tile_m in (16, 128):
        gids, rows, t_pad = _dispatch(rng, 40, E, KDIM, tile_m)
        xs = _sorted(rng.standard_normal((40, KDIM)).astype(np.float32), rows, t_pad)
        jx = jnp.asarray(xs).astype(dtype)
        ref = np.asarray(op(jx, jnp.asarray(gids), ref_qt, tile_m=tile_m).astype(jnp.float32))
        staged = torch.from_numpy(np.array(jx.astype(jnp.float32)))
        y = wg_model(staged, torch.from_numpy(gids), _t(ref_qt.packed), _t(ref_qt.scales),
                     _t(ref_qt.zero_points), tile_m, gs)
        if dtype == "bfloat16":
            y = y.bfloat16().float()
        pad = (xs == 0).all(axis=1)
        assert pad.any() and np.all(y.numpy()[pad] == 0)
        assert np.max(np.abs(y.numpy() - ref)) <= TOL[dtype] * np.max(np.abs(ref))


@pytest.mark.parametrize("kernel", ["K2", "K13"])
def test_wg_model_token_rows_equal_across_tile_m(rng, kernel):
    """One routing dispatched at tile_m 16, 32, 64 and 128 puts the tokens in
    other rows and runs; through the warpgroup body's model their rows are
    the same bits, as the kernel's must be within its domain."""
    w = torch.from_numpy(rng.standard_normal((E, N, KDIM)).astype(np.float32)) * KDIM ** -0.5
    gs = 128 if kernel == "K13" else 0
    qt = (quantize(w, granularity="per_group", layout="planar_groups", group_size=gs) if gs
          else quantize(w))
    x = rng.standard_normal((40, KDIM)).astype(np.float32)
    logits = rng.standard_normal((40, E)).astype(np.float32)
    got = []
    for tile_m in WG_TILES:
        gids, rows, t_pad = _dispatch(rng, 40, E, KDIM, tile_m, logits)
        xs = torch.from_numpy(_sorted(x, rows, t_pad)).bfloat16().float()
        y = wg_model(xs, torch.from_numpy(gids), qt.packed, qt.scales, qt.zero_points, tile_m, gs)
        got.append((y[torch.from_numpy(rows)], rows))
    for y, rows in got[1:]:
        assert not np.array_equal(rows, got[0][1])
        assert torch.equal(y, got[0][0])


def test_walk_order_of_the_linear_rules_is_the_single_stage_one():
    """Where K1's and K7's rules put kw > 1 warps along K, a warp holds one
    stage (ws <= 32), so the body's stage order is the contiguous split they
    have always had: their rows keep their bits."""
    for n, k in ((4096, 4096), (1024, 4096), (8, 4096), (8192, 4096), (384, 512)):
        for rule in (_mma_launch, _fold_mma_launch):
            ws, kw, _ = rule(n, k, SMS)
            assert kw == 1 or ws <= STAGE


# --- the model against JAX's kernels in interpret mode ------------------------

E, N, KDIM, TILE_M = 4, 384, 512, 16


LAYOUT = {"K13": "planar_groups", "K12": "planar"}   # per group of 128; K2, K9 per row


def _launch(kernel):
    """The launch rule of ``kernel`` at the tests' shape."""
    rule = _mma._ksplit_mma_launch if kernel == "K9" else _mma._grouped_mma_launch
    return rule(N, KDIM, SMS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [8, 40])
@pytest.mark.parametrize("kernel", ["K2", "K13", "K12", "K9"])
def test_grouped_model_matches_jax_kernel(rng, kernel, t, dtype):
    """The model at the kernel's launch shape against JAX's grouped kernel
    (K2: ``grouped_int4_matmul``; K9: the same with ``mode="ksplit"``, the
    model at K9's launch, K split across CTAs; K13 and K12:
    ``grouped_int4_matmul_per_group`` on planar_groups and on planar bytes,
    gs 128) on the same bytes and the same dispatch, and the zero padding
    rows exactly 0."""
    w = rng.standard_normal((E, N, KDIM)).astype(np.float32) * KDIM ** -0.5
    gs = 128 if kernel in LAYOUT else 0
    ref_qt = (jax_quantize(jnp.asarray(w), granularity="per_group", layout=LAYOUT[kernel],
                           group_size=gs) if gs else jax_quantize(jnp.asarray(w)))
    gids, rows, t_pad = _dispatch(rng, t, E, KDIM, TILE_M)
    xs = _sorted(rng.standard_normal((t, KDIM)).astype(np.float32), rows, t_pad)
    jx = jnp.asarray(xs).astype(dtype)
    op = jax_grouped_pg if gs else jax_grouped
    mode = {"mode": "ksplit"} if kernel == "K9" else {}
    ref = np.asarray(op(jx, jnp.asarray(gids), ref_qt, tile_m=TILE_M, **mode).astype(jnp.float32))
    staged = torch.from_numpy(np.asarray(jx.astype(jnp.float32)))       # the staged values
    launch = _launch(kernel)
    if kernel == "K9":
        assert launch[2] >= 2
    dequant = getattr(torch, dtype) if kernel == "K12" else None
    y = grouped_model(staged, torch.from_numpy(gids), _t(ref_qt.packed), _t(ref_qt.scales),
                      _t(ref_qt.zero_points), TILE_M, launch, gs, dequant)
    if dtype == "bfloat16":
        y = y.bfloat16().float()
    pad = (xs == 0).all(axis=1)
    assert pad.any() and np.all(y.numpy()[pad] == 0)
    assert np.max(np.abs(y.numpy() - ref)) <= TOL[dtype] * np.max(np.abs(ref))


@pytest.mark.parametrize("kernel", ["K2", "K13", "K12", "K9"])
def test_grouped_model_token_rows_equal_in_t8_and_t40(rng, kernel):
    """The same 8 tokens in a T=8 and a T=40 dispatch sit in other rows and
    tiles; through the model at the rule's shape their rows are the same
    bits, as the kernel's must be."""
    w = torch.from_numpy(rng.standard_normal((E, N, KDIM)).astype(np.float32)) * KDIM ** -0.5
    gs = 128 if kernel in LAYOUT else 0
    qt = (quantize(w, granularity="per_group", layout=LAYOUT[kernel], group_size=gs) if gs
          else quantize(w))
    dequant = torch.bfloat16 if kernel == "K12" else None
    x40 = rng.standard_normal((40, KDIM)).astype(np.float32)
    logits = rng.standard_normal((40, E)).astype(np.float32)
    launch = _launch(kernel)
    got = []
    for t in (8, 40):
        gids, rows, t_pad = _dispatch(rng, t, E, KDIM, TILE_M, logits)
        xs = torch.from_numpy(_sorted(x40[:t], rows, t_pad)).bfloat16().float()
        y = grouped_model(xs, torch.from_numpy(gids), qt.packed, qt.scales, qt.zero_points,
                          TILE_M, launch, gs, dequant)
        got.append((y[torch.from_numpy(rows[:16])], rows[:16]))
    (y8, r8), (y40, r40) = got
    assert not np.array_equal(r8, r40)
    assert torch.equal(y8, y40)


def test_ctypes_signatures_match_the_c_entry_points():
    """Every C entry point of ``csrc/`` is declared to ctypes with its own
    parameters, a pointer for each pointer, a float for each float (K15's
    softmax scale) and an int for each int: ctypes passes arguments beyond
    the declared ones unconverted, so a count that is one short hands the
    kernel a size where it reads its stream."""
    import re

    from fused4bit_tpu_torch.ops import _build

    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[name] = [_build._P if "*" in p else _build._F if "float" in p else _build._I
                           for p in params.split(",")]
    assert found == _build._SIGNATURES
