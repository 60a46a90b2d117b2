"""K5, the per-row w4a8 linear that quantizes its own activations, and K4,
the same product on the host quantizer's arithmetic, on the int8 tensor-core
body (``csrc/int8_mma.cuh``, K10's arithmetic run as a one-expert stack),
and K11 beside them, in what the CPU can check:

* K5's launch rule ``_row_a8_launch`` at the layer2 linear shapes;
* a plain-numpy model of one warp's mma.sync m16n8k32 fragments run as K5
  (no tile map, M not a multiple of 16, a zero row), which must equal the
  plain version with the fused quantizer bit for bit;
* a row's output bits in an 8-row and a 40-row call;
* the quantizer each wrapper hands the body's first pass: K5 and K11 multiply
  by f32(1/127), K10 and K4 divide by 127 (``tests/test_torch_a8.py`` shows
  the two differ in the last bit of some scales), and K4's launch shape.

The body's integer sums are exact, so K5's bits do not depend on its launch
shape; ``chip_smoke.check_linear_a8`` holds the kernel to its plain version
bit for bit on the card. No tolerance is used here: every comparison is
exact.
"""
import contextlib
import inspect

import numpy as np
import pytest
import torch

from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.ops import _build, _front
from fused4bit_tpu_torch.ops._int8 import (
    _a8_mma_launch,
    _a8_product,
    _linear_a8_launch,
    _row_a8_launch,
)
from fused4bit_tpu_torch.ops.int8_xla import _quantize_acts
from fused4bit_tpu_torch.quant import quantize
from test_torch_grouped_a8_mma import _model_warp, _scatter

SMS = 132   # the H100's SMs
K = 4096    # the layer2 linears' K
LAYER2_LINEARS = {"q_o": 4096, "k_v": 1024, "lm_head": 8192, "router": 8}


# --- the launch rule --------------------------------------------------------


@pytest.mark.parametrize("proj, m, want", [
    ("q_o", 8, (4, 8, 1)), ("k_v", 8, (4, 8, 1)), ("lm_head", 8, (8, 4, 1)),
    ("router", 8, (4, 8, 1)),
    ("q_o", 640, (16, 2, 1)), ("k_v", 640, (4, 8, 1)), ("lm_head", 640, (32, 1, 1)),
    ("router", 640, (1, 8, 4)),
])
def test_k5_launch_rule_at_the_layer2_linears(proj, m, want):
    """K5's shape: K8's decode rule per row up to 64 rows, the grouped rule
    above. Its slices (ws chunks of 64 packed bytes per warp, kw warps,
    splits CTAs) cover K/2's 32 chunks exactly; at decode every SM gets a
    CTA wherever the row tiles allow it, else each row tile takes all 8
    warps along K (k/v, the router: no split of K, which measured slower
    for K8 at k/v on the H100)."""
    n = LAYER2_LINEARS[proj]
    assert list(inspect.signature(_row_a8_launch).parameters) == ["n", "k", "m", "sms"]
    ws, kw, splits = _row_a8_launch(n, K, m, SMS)
    assert (ws, kw, splits) == want
    assert ws * kw * splits * 64 == K // 2
    tiles = -(-n // 16)
    ctas = -(-tiles // (8 // kw)) * splits
    if m <= 64:
        assert splits == 1 and (ctas >= SMS or kw == 8)
        assert (ws, kw, splits) == _linear_a8_launch(n, K, 0, SMS)
    else:
        assert (ws, kw, splits) == _a8_mma_launch(n, K, 0, SMS)


def test_k5_launch_rule_reads_m_only_past_64_rows():
    """Up to 64 rows (decode, the self-draft verify) the shape is the same at
    every M; it changes above (the prefill). Either way the bits do not:
    the int32 sums are exact."""
    for n in LAYER2_LINEARS.values():
        assert len({_row_a8_launch(n, K, m, SMS) for m in (1, 8, 13, 40, 64)}) == 1
    assert _row_a8_launch(4096, K, 64, SMS) != _row_a8_launch(4096, K, 65, SMS)


# --- a model of the fragments, run as K5 -------------------------------------


def test_fragment_model_k5_equals_the_plain_product(rng):
    """K5's warps with no tile map: 13 rows of x (the block's rows past M
    read as zeros), row 5 zero and row 12 zero (past the block's last row in
    use, written as 0), the fused quantizer; 2 warps along K, their int32
    sums added, then JAX's epilogue: bit for bit ``_a8_product`` on
    ``_quantize_acts(x, fused=True)``, the plain version of K5."""
    m, n, k = 13, 32, 512                      # 4 chunks of 64 bytes, 2 row tiles
    qt = quantize(torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32) * 3.0).bfloat16()
    x[5] = 0
    x[12] = 0
    xq, sx = _quantize_acts(x, fused=True)
    xq16 = torch.zeros((16, k), dtype=torch.int8)
    xq16[:m] = xq                              # rows past M: zeros
    packed = qt.packed.numpy()
    acc = np.zeros((16, n), np.int64)
    for n0 in (0, 16):
        for tile in (0, 1):
            frag = sum(_model_warp(xq16, packed, n0, tile, c0, c0 + 2, 0, 16, None)
                       for c0 in (0, 2))
            _scatter(frag, acc, n0, tile)
    used = xq.abs().sum(dim=1).numpy() > 0
    mcount = int(np.nonzero(used)[0].max()) + 1
    assert mcount == 12
    xsum = xq.numpy().astype(np.int64).sum(axis=1)
    s, zp, sxn = qt.scales.numpy(), qt.zero_points.numpy(), sx.numpy()[:, 0]
    yq = acc[:m].astype(np.float32) - zp[None, :] * xsum[:, None].astype(np.float32)
    y = (s[None, :] * sxn[:, None]) * yq
    y[mcount:] = 0.0
    want = _a8_product(xq, sx, qt.packed, qt.scales, qt.zero_points)
    np.testing.assert_array_equal(y, want.numpy())
    assert not want[5].any() and not want[12].any()
    plain = ops.int4_matmul_a8_reference(x, qt, fuse_quant=True)
    assert torch.equal(plain, want.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_rows_do_not_depend_on_m(rng, dtype):
    """Rows 0-7 of a 40-row K5 call (the self-draft verify) equal the 8-row
    call (a decode step) bit for bit, through the wrapper on a CPU tensor."""
    qt = quantize(torch.from_numpy(rng.standard_normal((96, 256)).astype(np.float32)))
    x40 = torch.from_numpy(rng.standard_normal((40, 256)).astype(np.float32)).to(dtype)
    y8 = ops.int4_matmul_a8(x40[:8], qt, fuse_quant=True)
    y40 = ops.int4_matmul_a8(x40, qt, fuse_quant=True)
    assert y8.dtype == dtype and torch.equal(y8, y40[:8])


# --- the quantizer each wrapper hands the first pass -------------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that calls itself a CUDA tensor, so that a wrapper takes
    its card branch as far as the launch, which the test replaces."""

    @property
    def is_cuda(self):
        return True


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
def int8_launches(monkeypatch):
    """Replace the kernel library with a stub and the card's SM count with
    the H100's; returns a reader of the int8 body's launches so far, each
    (tile map, granularity, tile_m, launch shape, fused): its main kernel's
    tile map (None: a linear), weights, tile_m and shape, and its first
    pass's quantizer."""
    lib = _StubLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_front, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())

    def launches():
        out = []
        for (first, a), (main, b) in zip(lib.calls[::2], lib.calls[1::2]):
            assert first.startswith("f4b_a8_prepass_") and main.endswith("a8_mma"), (first, main)
            pg = int("_pg_" in main)              # the group size follows K
            out.append((b[4], "per_group" if pg else "per_row", b[13 + pg],
                        tuple(b[15 + pg:18 + pg]), bool(a[8])))
        return out
    return launches


def test_each_wrapper_hands_the_first_pass_its_quantizer(rng, int8_launches):
    """K5 (at a decode step's 8 rows and at 80, past its launch rule's
    switch) and K11 pass ``fused=True``, K10 and K4 ``fused=False``, K8 and
    K14 ``fused=True``: a slip gives rows off in the last bit."""
    k, n, e, tile_m = 256, 64, 2, 32
    w = torch.from_numpy(rng.standard_normal((e, n, k)).astype(np.float32))
    qt, qe = quantize(w[0]), quantize(w)
    pg = quantize(w[0], granularity="per_group", layout="planar_groups", group_size=128)
    pge = quantize(w, granularity="per_group", layout="planar_groups", group_size=128)
    gids = torch.zeros((2,), dtype=torch.int32)
    xs = torch.from_numpy(rng.standard_normal((80, k)).astype(np.float32))
    on_card = xs.bfloat16().as_subclass(_OnCard)

    ops.int4_matmul_a8(on_card[:8], qt, fuse_quant=True)              # K5, decode
    ops.int4_matmul_a8(on_card, qt, fuse_quant=True)                  # K5, 80 rows
    ops.int4_matmul_a8(on_card[:8], qt, fuse_quant=False)             # K4
    on_card = on_card[:2 * tile_m]
    ops.grouped_int4_matmul_a8(on_card, gids, qe, tile_m=tile_m, fuse_quant=True)     # K11
    ops.grouped_int4_matmul_a8(on_card, gids, qe, tile_m=tile_m)                      # K10
    ops.int4_matmul_per_group_a8(on_card[:8], pg)                                     # K8
    ops.grouped_int4_matmul_per_group_a8(on_card, gids, pge, tile_m=tile_m)           # K14
    assert [("linear" if gids is None else "grouped", gran, fused)
            for gids, gran, _, _, fused in int8_launches()] == [
        ("linear", "per_row", True), ("linear", "per_row", True), ("linear", "per_row", False),
        ("grouped", "per_row", True), ("grouped", "per_row", False),
        ("linear", "per_group", True), ("grouped", "per_group", True)]


@pytest.mark.parametrize("m, k, fuse_quant", [
    (8, K, False),       # a decode step's rows, asked for K4
    (80, K, False),      # past the launch rule's switch at 64 rows
    (8, 6400, None),     # deep K: the JAX fuse gate picks K4 by itself
])
def test_k4_launches_the_int8_body_with_the_dividing_first_pass(rng, int8_launches, m, k,
                                                                 fuse_quant):
    """K4 on a CUDA tensor reaches the int8 body's launcher once, one expert
    (no tile map), per-row weights, at ``_row_a8_launch``'s shape, with the
    host quantizer's division (``fused=False``), and counts one K4 launch and
    no K5 launch."""
    n = 64
    qt = quantize(torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).bfloat16()
    before = (ops.int4_matmul_a8.launches, ops.int4_matmul_a8.fused_launches)
    y = ops.int4_matmul_a8(x.as_subclass(_OnCard), qt, fuse_quant=fuse_quant)
    assert y.shape == (m, n)
    assert int8_launches() == [(None, "per_row", 0, _row_a8_launch(n, k, m, SMS), False)]
    assert (ops.int4_matmul_a8.launches, ops.int4_matmul_a8.fused_launches) == (
        before[0] + 1, before[1])
