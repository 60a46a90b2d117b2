"""K7's tall calls on the warpgroup body (``csrc/grouped_wgmma.cu``,
``int4_mma_kernel_wg<GroupFold, false>``), in what the CPU can check: the
body choice as a function of the call's type and shape, the launch rule's
walk over the per-group cells' linears, a plain-torch model of the body's
sum order (against the plain version and the JAX package's K7), the
launch rule's picks against the launches timed on the card, the kernels'
names against the benchmark's family rules, and which C entry point each
wrapper reaches (a stub library records it).

The model repeats the body's order where it is fixed: over all of K/2 (a
whole item) or per range z of K/2's chunks (the slices
``_wg_linear_launch`` cuts into ``splits`` ranges), the chunks in order,
each folded
``acc += s_lo*P_lo; acc += c_lo*X_lo; acc += s_hi*P_hi; acc += c_hi*X_hi``
(``test_torch_pg_mma.k7_fold_model`` at one warp along K); the ranges'
partials added in order z = 0, 1, ... Where it is not (the tensor core's
order inside a k step, the FMA's single rounding), the model sums exactly
and rounds once. Tolerance against the plain version and JAX's K7: 1e-3
of the largest output in f32 (the f32 sums in another order).
"""
import contextlib
import importlib
import inspect
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import PG_LINEAR_SHAPES
from fused4bit_tpu.ops.int4_matmul import int4_matmul_per_group as jax_pg
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.ops import _build, _front, _mma, _wg
from fused4bit_tpu_torch.quant import quantize
from test_torch_pg_mma import CHUNK, SMS, _jax_pg, _t, k7_fold_model

im = importlib.import_module("fused4bit_tpu_torch.ops.int4_matmul")

# (M, N, K) of the per-group cells' K7 linears: K-EXAONE-236B at 896 rows,
# Mixtral-8x22B at 384 (chip_smoke names each)
CELL_SHAPES = [(m, n, k) for m, shapes in PG_LINEAR_SHAPES.items() for n, k in shapes]
BF16 = torch.bfloat16


def _pg(w, gs=128):
    return quantize(w, granularity="per_group", layout="planar_groups", group_size=gs)


def _wg_body(dtype, gs, m, n, k):
    """Whether a K7 call takes the warpgroup body on the card."""
    return im._body("K7", True, dtype, gs, m, n, k) == "wg"


def test_body_choice_reads_the_call_type_and_shape_only():
    """The choice reads (kernel, device, dtype, gs, M, N, K), the launch (M,
    N, K, SMs): never the model, the layer or an environment variable."""
    assert list(inspect.signature(im._body).parameters) == [
        "kernel", "cuda", "dtype", "group_size", "m", "n", "k", "prefill_threshold"]
    assert list(inspect.signature(_wg._wg_linear_launch).parameters) == [
        "m", "n", "k", "sms", "kernel"]
    assert _mma._MMA_TALL_M < im.WG_MIN_LINEAR_ROWS <= 320
    for m, n, k in CELL_SHAPES:
        assert _wg_body(BF16, 128, m, n, k)


@pytest.mark.parametrize("m,n,k", CELL_SHAPES)
def test_decode_verify_routers_and_other_formats_keep_their_launch(m, n, k):
    """Decode and the verify (M <= 64) at every cell width, rows below the
    crossover, 8x22B's router (N=8), N in no whole slices of 128, group
    sizes off 64, and f32 x never take the body."""
    for rows in {1, 8, 40, 64, im.WG_MIN_LINEAR_ROWS - 1}:
        assert not _wg_body(BF16, 128, rows, n, k)
    assert _wg_body(BF16, 128, im.WG_MIN_LINEAR_ROWS, n, k)
    assert _wg_body(BF16, 64, m, n, k)
    assert not _wg_body(BF16, 128, m, 8, k)                      # the router
    assert not _wg_body(BF16, 128, m, n - 64, k)                # N off 128
    for gs in (16, 32, 96):
        assert not _wg_body(BF16, gs, m, n, k)
    assert not _wg_body(torch.float32, 128, m, n, k)


def _walk(m, n, k, full, splits, grid):
    """The body's items, as csrc/grouped_wgmma.cu's linear_item walks them:
    CTA b takes items b, b + grid, ...; item -> (n0, r0, c0, c1, z): the
    first ``full`` over all of K/2 (z -1), then ``splits`` ranges of each
    slice left; slices outermost, then ranges, the row blocks innermost."""
    chunks = (k // 2) // _wg._WG_CHUNK
    blocks = -(-m // _wg._WG_ROWS)
    span = -(-chunks // splits)
    items = full + (n // _wg._WG_SLICE - full // blocks) * splits * blocks
    out = []
    for cta in range(grid):
        for item in range(cta, items, grid):
            if item < full:
                s, b = divmod(item, blocks)
                out.append((s * _wg._WG_SLICE, b * _wg._WG_ROWS, 0, chunks, -1))
                continue
            s, rest = divmod(item - full, splits * blocks)
            z, b = divmod(rest, blocks)
            out.append(((full // blocks + s) * _wg._WG_SLICE, b * _wg._WG_ROWS, z * span,
                        min(chunks, (z + 1) * span), z))
    return out


@pytest.mark.parametrize("m,n,k", CELL_SHAPES)
def test_launch_covers_every_output_once(m, n, k):
    """At every cell shape the persistent grid walks each item once; the
    whole items are whole slices over all of K/2; every (row, feature) of
    the other slices lies in exactly one item of each range, and the ranges
    cut K/2's chunks in order into non-empty runs; the grid never exceeds
    the SMs or the items."""
    assert_launch_covers(m, n, k, "K7")


def assert_launch_covers(m, n, k, kernel):
    """The checks of :func:`test_launch_covers_every_output_once` on
    ``kernel``'s launch at (M, N, K)."""
    full, splits, grid = _wg._wg_linear_launch(m, n, k, SMS, kernel)
    chunks = (k // 2) // CHUNK
    blocks = -(-m // _wg._WG_ROWS)
    slices = n // _wg._WG_SLICE
    whole = full // blocks
    items = full + (slices - whole) * splits * blocks
    assert 1 <= splits <= _wg._WG_MAX_SPLITS and 1 <= grid <= min(SMS, items)
    assert full % blocks == 0 and 0 <= full <= slices * blocks
    assert splits > 1 or full == slices * blocks
    walked = _walk(m, n, k, full, splits, grid)
    assert len(walked) == items == len(set(walked))
    rows = range(0, blocks * _wg._WG_ROWS, _wg._WG_ROWS)
    assert sorted((n0, r0) for n0, r0, _, _, z in walked if z < 0) == \
        [(s * _wg._WG_SLICE, r0) for s in range(whole) for r0 in rows]
    assert all((c0, c1) == (0, chunks) for _, _, c0, c1, z in walked if z < 0)
    if whole < slices:
        ranges = sorted({(c0, c1, z) for _, _, c0, c1, z in walked if z >= 0},
                        key=lambda r: r[2])
        assert [z for _, _, z in ranges] == list(range(splits))
        assert ranges[0][0] == 0 and ranges[-1][1] == chunks
        assert all(c0 < c1 for c0, c1, _ in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        for z in range(splits):
            tiles = sorted((n0, r0) for n0, r0, _, _, zz in walked if zz == z)
            assert tiles == [(s * _wg._WG_SLICE, r0) for s in range(whole, slices) for r0 in rows]
    assert blocks * _wg._WG_ROWS - m < _wg._WG_ROWS                      # rows past M: one block's


def test_launch_fills_the_card_where_whole_items_do_not():
    """Where whole items fall short of the card, every slice is cut into
    ranges: K-EXAONE's k and v (56 items at 896 rows), 8x22B's (24 at 384);
    where they leave a ragged last wave, the slices of the whole waves stay
    whole and the rest are cut: 8x22B's q and o (144 items: one wave of 132
    whole, 4 slices in ranges); 8x22B's LM head (768 items) stays whole."""
    for m in (896, 384):
        full, splits, grid = _wg._wg_linear_launch(m, 1024, 6144, SMS, "K7")
        assert full == 0 and splits > 1 and grid > 8 * -(-m // 128)
    full, splits, grid = _wg._wg_linear_launch(384, 6144, 6144, SMS, "K7")
    assert (full, grid) == (SMS, SMS) and splits > 1
    assert _wg._wg_linear_launch(384, 32768, 6144, SMS, "K7") == (768, 1, SMS)


# Milliseconds of the body at each cell shape under the launches
# ``scripts/linear_sweep.py --pg`` timed, keyed (full, splits) as
# ``_wg_linear_launch`` gives them (all items whole: (items, 1)); the fastest
# of a launch's readings; H100 80GB HBM3 at 700 W (PERF.md section 6).
TIMED_LAUNCHES = {
    (896, 8192, 6144): {(0, 2): 0.3799, (0, 3): 0.4259, (0, 4): 0.4395, (392, 2): 0.3376,
                        (392, 3): 0.3575, (448, 1): 0.3769},
    (896, 1024, 6144): {(0, 2): 0.0636, (0, 3): 0.0838, (0, 4): 0.0716, (56, 1): 0.1013},
    (896, 6144, 8192): {(0, 2): 0.4236, (0, 3): 0.4064, (0, 4): 0.4370, (259, 2): 0.3957,
                        (259, 3): 0.3606, (259, 4): 0.3731, (336, 1): 0.3871},
    (896, 2048, 6144): {(0, 2): 0.1181, (0, 3): 0.1246, (0, 4): 0.1359, (112, 1): 0.1034},
    (896, 6144, 2048): {(0, 2): 0.1426, (0, 3): 0.1555, (0, 4): 0.1823, (336, 1): 0.1023},
    (896, 18432, 6144): {(0, 2): 0.8603, (0, 3): 0.8917, (0, 4): 0.9653, (924, 2): 0.7699,
                         (924, 3): 0.7409, (924, 4): 0.7538, (1008, 1): 0.7582},
    (896, 6144, 18432): {(0, 2): 0.8963, (0, 3): 0.8187, (0, 4): 0.8656, (259, 4): 0.8078,
                         (259, 5): 0.7404, (259, 6): 0.7876, (336, 1): 0.8419},
    (896, 153600, 6144): {(0, 2): 6.5407, (0, 3): 7.0182, (0, 4): 7.5935, (8316, 2): 5.7651,
                          (8316, 3): 5.7406, (8316, 4): 5.7448, (8400, 1): 5.7879},
    (384, 6144, 6144): {(0, 2): 0.1684, (0, 3): 0.1641, (0, 4): 0.1713, (132, 7): 0.1273,
                        (132, 8): 0.1256, (144, 1): 0.1988},
    (384, 1024, 6144): {(0, 2): 0.0600, (0, 3): 0.0468, (0, 4): 0.0400, (0, 5): 0.0375,
                        (0, 6): 0.0529, (24, 1): 0.1082},
    (384, 32768, 6144): {(0, 2): 0.6344, (0, 3): 0.6842, (0, 4): 0.7381, (768, 1): 0.5547},
}


@pytest.mark.parametrize("m,n,k", CELL_SHAPES)
def test_launch_rule_picks_the_fastest_timed_launch(m, n, k):
    """The rule's fitted constants pick, at every cell shape, a launch that
    was timed on the card and read within 1 % of the fastest timed there
    (the readings' noise between near-equal launches); a change to a
    constant must keep that."""
    timed = TIMED_LAUNCHES[(m, n, k)]
    full, splits, _ = _wg._wg_linear_launch(m, n, k, SMS, "K7")
    assert (full, splits) in timed
    assert timed[(full, splits)] <= 1.01 * min(timed.values())


def body_launch(m, n, k, splits=None):
    """The body's order as ``k7_fold_model``'s launch: one warp along K,
    ``splits`` CTAs along K (the ranges, the rule's by default) of
    ceil(chunks / splits) chunks each, added in order z = 0, 1, ..."""
    splits = splits or _wg._wg_linear_launch(m, n, k, SMS, "K7")[1]
    chunks = (k // 2) // CHUNK
    return 8 * -(-chunks // splits), 1, splits


MODEL_CASES = [(200, 256, 1024, None), (200, 256, 1024, 1), (130, 128, 512, 2),
               (96, 384, 2048, 3), (256, 128, 2560, 5)]


@pytest.mark.parametrize("m,n,k,splits", MODEL_CASES)
def test_body_model_matches_plain_version(rng, m, n, k, splits):
    """The body's sum order (ranges of whole chunks, each folded in order,
    the partials added in order) against the plain version on tiny shapes,
    the rule's ranges and forced ones; its ranges cover K/2 once."""
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)) * k ** -0.5
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    qt = _pg(w)
    ws, kw, sp = body_launch(m, n, k, splits)
    chunks = (k // 2) // CHUNK
    assert (sp - 1) * (ws // 8) < chunks <= sp * (ws // 8)
    y = k7_fold_model(x, qt.packed, qt.scales, qt.zero_points, (ws, kw, sp))
    ref = ops.int4_matmul_per_group_reference(x, qt)
    assert torch.max(torch.abs(y - ref)) <= 1e-3 * torch.max(torch.abs(ref))


@pytest.mark.parametrize("m,n,k,splits", MODEL_CASES)
def test_body_model_matches_jax_kernel(rng, m, n, k, splits):
    """The same model, ranges included, against the JAX package's K7 in
    interpret mode on the same bytes: the weight quantized by JAX (the
    port's quantizer gives the same bytes, scales and zero points), x at the
    bf16 values the body stages, both sides in f32; and against the plain
    version on the same inputs."""
    w = rng.standard_normal((n, k)).astype(np.float32) * k ** -0.5
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).bfloat16().float()
    ref_qt = _jax_pg(w, 128)
    qt = _pg(torch.from_numpy(w))
    for mine, theirs in ((qt.packed, ref_qt.packed), (qt.scales, ref_qt.scales),
                         (qt.zero_points, ref_qt.zero_points)):
        assert torch.equal(mine, _t(theirs))
    y = k7_fold_model(x, _t(ref_qt.packed), _t(ref_qt.scales), _t(ref_qt.zero_points),
                      body_launch(m, n, k, splits))
    want = torch.from_numpy(np.array(jax_pg(jnp.asarray(x.numpy()), ref_qt)))
    assert torch.max(torch.abs(y - want)) <= 1e-3 * torch.max(torch.abs(want))
    ref = ops.int4_matmul_per_group_reference(x, qt)
    assert torch.max(torch.abs(y - ref)) <= 1e-3 * torch.max(torch.abs(ref))


def test_split_partials_merge_in_range_order(rng):
    """The partials of the ranges are added in order z = 0, 1, ...: the
    model equals the ranges' own folds summed in that order bit for bit,
    and summing them in another order gives other bits on these inputs."""
    m, n, k, splits = 64, 128, 4096, 4
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)) * k ** -0.5
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    qt = _pg(w)
    ws, _, _ = body_launch(m, n, k, splits)
    parts = []
    for z in range(splits):
        keep = torch.zeros_like(x)
        lo, hi = z * ws * 8, (z + 1) * ws * 8             # the range's columns of each half
        kh = k // 2
        keep[:, lo:hi], keep[:, kh + lo:kh + hi] = 1.0, 1.0
        parts.append(k7_fold_model(x * keep, qt.packed, qt.scales, qt.zero_points, (ws, 1, splits)))
    y = k7_fold_model(x, qt.packed, qt.scales, qt.zero_points, (ws, 1, splits))
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    assert torch.equal(y, total)
    backwards = parts[-1]
    for part in parts[-2::-1]:
        backwards = backwards + part
    assert not torch.equal(y, backwards)


def _family_rules():
    """The benchmark's kernel-family rules of the linear and expert rooflines."""
    import importlib.util

    rules = {}
    for name in ("grouped_matmul_roofline", "int4_matmul_roofline"):
        path = pathlib.Path(__file__).resolve().parents[1] / "portbench" / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        rules[name] = mod._main
    return rules


def test_kernel_names_fall_in_the_linears_family():
    """Every kernel the path launches (the body's GroupFold instance, and
    K1's RowScale one, with the grouped flag false, then where slices are
    cut into ranges the ordered second pass), mangled as nvcc names it and
    demangled as the profiler may give it, is counted among the linears and
    not among the experts; the second pass joins the main kernel it
    follows."""
    from portbench import trace

    src = (_build.CSRC / "grouped_wgmma.cu").read_text()
    body = src[src.index("int launch_int4_linear_wg("):]
    body = body[:body.index("\n}\n")]
    launched = re.findall(r"(\w+(?:<[^<>]*>)?)<<<", body)
    assert launched == ["int4_mma_kernel_wg<P, false>", "int4_linear_reduce_kernel"]
    assert re.findall(r"launch_int4_linear_wg<f4b::(\w+)>", src) == ["RowScale", "GroupFold"]
    ns = "_ZN3f4b49_GLOBAL__N__3a36cd68_16_grouped_wgmma_cu_f47962b8"
    anon = "f4b::(anonymous namespace)::"
    mains = tuple(name for policy in ("GroupFold", "RowScale") for name in (
        f"{ns}18int4_mma_kernel_wgINS0_{len(policy)}{policy}ELb0EEEv14CUtensorMap_stS3_NS0_6WgArgsE",
        f"void {anon}int4_mma_kernel_wg<{anon}{policy}, false>(CUtensorMap_st, "
        f"CUtensorMap_st, {anon}WgArgs)"))
    seconds = (f"{ns}25int4_linear_reduce_kernelEPKfS2_P13__nv_bfloat16iiii",
               f"{anon}int4_linear_reduce_kernel(float const*, float const*, __nv_bfloat16*, "
               "int, int, int, int)")
    rules = _family_rules()
    for main in mains:
        assert trace.grouped_flag(main) is False
        assert rules["int4_matmul_roofline"](main) and not rules["grouped_matmul_roofline"](main)
    for second in seconds:
        assert trace.grouped_flag(second) is None and "rows_used_kernel" not in second
        assert not rules["int4_matmul_roofline"](second)
        assert not rules["grouped_matmul_roofline"](second)
    ops_ = [trace.DeviceOp(name, "kernel", ts, 10.0) for ts, name in
            enumerate((mains[0], seconds[0], mains[1], seconds[1]))]
    assert trace.family_ms(ops_, rules["int4_matmul_roofline"]) == pytest.approx(0.04)
    assert trace.family_ms(ops_, rules["grouped_matmul_roofline"]) == 0.0


class _StubLibrary:
    """Records each C entry point called and its arguments; returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_front, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    body = im._body
    monkeypatch.setattr(im, "_body", lambda kernel, cuda, *a: body(kernel, True, *a))
    return lib


@pytest.mark.parametrize("m", [8, 40, 64, 65, 127, 128, 384, 896])
def test_wrappers_reach_their_entry_points(stub, m):
    """What each wrapper calls at M rows (CPU tensors taking the card's
    bodies, a stub library): K7 at bf16 the body from WG_MIN_LINEAR_ROWS
    rows (N=1024) at the rule's launch, with an f32 partial where slices are
    cut into ranges, else the tall or decode tile, and never for the router
    (N=8), gs 32, f32 x or K6; K1 its own entry on the body from the same
    rows; the ``wg_launches`` counters count the body's launches alone."""
    k = 1024
    gen = torch.Generator().manual_seed(m)
    w = torch.randn((1024, k), generator=gen) * k ** -0.5
    x = torch.randn((m, k), generator=gen).bfloat16()
    cases = [("K7", _pg(w), x), ("router", _pg(w[:8]), x), ("gs32", _pg(w, 32), x),
             ("f32", _pg(w), x.float()),
             ("K6", quantize(w, granularity="per_group", layout="planar", group_size=128), x)]
    ops.reset_counts()
    for name, qt, xx in cases:
        stub.calls.clear()
        ops.int4_matmul_per_group(xx, qt)
        (entry, args), = stub.calls
        wg = name == "K7" and m >= im.WG_MIN_LINEAR_ROWS
        assert (entry == _wg._ENTRIES["K7"]) == wg, (name, entry)
        if wg:
            full, splits, grid = _wg._wg_linear_launch(m, 1024, k, SMS, "K7")
            assert args[6:13] == (m, 1024, k, 128, full, splits, grid)
            assert (args[5] is None) == (full == 8 * -(-m // 128))
    stub.calls.clear()
    ops.int4_matmul(x, quantize(w), prefill_threshold=m)
    wg = m >= im.WG_MIN_LINEAR_ROWS
    assert [entry for entry, _ in stub.calls] == [
        _wg._ENTRIES["K1"] if wg else "f4b_int4_matmul_bf16"]
    counts = ops.launch_counts()
    assert counts["int4_matmul_per_group_wg"] == counts["int4_matmul_wg"] == int(wg)
    assert counts["int4_matmul_per_group"] == 4 and counts["int4_matmul_per_group_planar"] == 1
    ops.reset_counts()
    assert ops.launch_counts()["int4_matmul_per_group_wg"] == 0
