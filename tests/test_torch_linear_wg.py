"""K1's tall calls on the warpgroup body (``csrc/grouped_wgmma.cu``,
``int4_mma_kernel_wg<RowScale, false>``), in what the CPU can check: the
launch rule at Mixtral-8x7B's linears (it reads the shape, the SMs and the
kernel only, covers each output once, cuts slices where whole items leave
the card ragged, and leaves K7's picks as they were), a plain-torch model of
the body's sum order against the plain version and the JAX package's K1,
and the C entry point the wrapper reaches at each row count (a stub
library).

The model repeats the body's order where it is fixed: per range z of K/2's
chunks (all of K/2 for a whole item), the chunks in order, each its low
columns' products x * (q - zp), then its high ones'; the ranges' raw f32
partials added in order z = 0, 1, ...; then s[n] times the sum, once.
Where it is not (the tensor core's order inside a k step), the model sums
a half chunk exactly and rounds once. Tolerance against the plain version
and JAX's K1: 1e-3 of the largest output in f32 (the f32 sums in another
order).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K1_CELL_ROWS, K1_LINEAR_SHAPES
from fused4bit_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from fused4bit_tpu.quant.core import quantize as jax_quantize
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.ops import _wg
from fused4bit_tpu_torch.quant import QuantizedTensor, quantize, unpack_planar
from test_torch_pg_linear_wg import assert_launch_covers, stub  # noqa: F401 (a fixture)
from test_torch_pg_mma import CHUNK, SMS

im = importlib.import_module("fused4bit_tpu_torch.ops.int4_matmul")

# (M, N, K) of Mixtral-8x7B's K1 linears on the body at its cell's 576 rows,
# and at 65 rows, the threshold and the layer2 LM head (8192 x 4096)
SHAPES = [(m, n, k) for n, k in K1_LINEAR_SHAPES + ((8192, 4096),)
          for m in (K1_CELL_ROWS, im.WG_MIN_LINEAR_ROWS, im.PREFILL_THRESHOLD)]

# K7's picks (full, splits, grid) at the per-group cells' linears, as the
# rule gave them before it took K1: a change for K1 must leave them so
K7_PICKS = {
    (896, 8192, 6144): (392, 2, 132), (896, 1024, 6144): (0, 2, 112),
    (896, 6144, 8192): (259, 3, 132), (896, 2048, 6144): (112, 1, 112),
    (896, 6144, 2048): (336, 1, 132), (896, 18432, 6144): (924, 3, 132),
    (896, 6144, 18432): (259, 5, 132), (896, 153600, 6144): (8316, 3, 132),
    (384, 6144, 6144): (132, 8, 132), (384, 1024, 6144): (0, 5, 120),
    (384, 32768, 6144): (768, 1, 132),
}


def test_launch_rule_keeps_k7_picks():
    """The rule reads (M, N, K, SMs) and the kernel, which stands for the
    weights' format; at every per-group cell shape K7's pick is what it was
    before the rule took K1."""
    for (m, n, k), pick in K7_PICKS.items():
        assert _wg._wg_linear_launch(m, n, k, SMS, "K7") == pick
    assert set(_wg._WG_CHUNK_US) == {"K1", "K7"}
    assert _wg._WG_CHUNK_US["K1"] < _wg._WG_CHUNK_US["K7"]          # no fold, no X sums


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_k1_launch_covers_every_output_once(m, n, k):
    """K1's launch at each shape: every item walked once, whole slices over
    all of K/2, the other slices' ranges covering K/2 in order, the grid
    within the SMs and the items."""
    assert_launch_covers(m, n, k, "K1")


def test_k1_launch_fills_the_card_where_whole_items_do_not():
    """At 576 rows the 8x7B cell's k and v (40 whole items) are cut into
    ranges whole; q and o (160 items on 132 SMs) keep the slices of one
    whole wave whole (26 of 32) and cut the rest; a ragged last wave of the
    LM head (1250 items) is cut the same way."""
    full, splits, grid = _wg._wg_linear_launch(K1_CELL_ROWS, 1024, 4096, SMS, "K1")
    assert full == 0 and splits > 1 and grid > 40
    full, splits, grid = _wg._wg_linear_launch(K1_CELL_ROWS, 4096, 4096, SMS, "K1")
    assert (full, grid) == (130, SMS) and splits > 1
    full, splits, grid = _wg._wg_linear_launch(K1_CELL_ROWS, 32000, 4096, SMS, "K1")
    assert full == 1250 // SMS * SMS // 5 * 5 and splits > 1 and grid == SMS


# Milliseconds of the body at the 8x7B cell's shapes (and the layer2 LM head)
# at 576 rows under the launches ``scripts/linear_sweep.py`` timed, keyed
# (full, splits) as ``_wg_linear_launch`` gives them (all items whole:
# (items, 1)); the fastest of a launch's readings; H100 80GB HBM3 at 700 W
# (PERF.md section 6).
TIMED_LAUNCHES = {
    (576, 4096, 4096): {(0, 2): 0.0658, (0, 3): 0.0719, (0, 4): 0.0817, (130, 3): 0.0530,
                        (130, 4): 0.0523, (130, 5): 0.0599, (160, 1): 0.0657},
    (576, 1024, 4096): {(0, 2): 0.0273, (0, 3): 0.0252, (0, 4): 0.0334, (40, 1): 0.0349},
    (576, 8192, 4096): {(0, 2): 0.1188, (0, 3): 0.1437, (0, 4): 0.1566, (260, 2): 0.0890,
                        (260, 3): 0.0991, (320, 1): 0.0973},
    (576, 32000, 4096): {(0, 2): 0.4001, (0, 3): 0.4704, (0, 4): 0.5341, (1185, 2): 0.2858,
                         (1185, 3): 0.2951, (1250, 1): 0.2930},
}


@pytest.mark.parametrize("m,n,k", TIMED_LAUNCHES)
def test_k1_launch_rule_picks_the_fastest_timed_launch(m, n, k):
    """K1's fitted chunk cost picks, at every shape timed, a launch that was
    timed on the card and read within 1 % of the fastest timed there."""
    timed = TIMED_LAUNCHES[(m, n, k)]
    full, splits, _ = _wg._wg_linear_launch(m, n, k, SMS, "K1")
    assert (full, splits) in timed
    assert timed[(full, splits)] <= 1.01 * min(timed.values())


def body_model(x: torch.Tensor, qt: QuantizedTensor, splits: int) -> torch.Tensor:
    """The body's K1 in plain torch, f32 out: x [M, K] (its values as the
    kernel stages them), per-row planar weights, K/2's chunks cut into
    ``splits`` ranges of ceil(chunks / splits)."""
    m, k = x.shape
    kh = k // 2
    chunks = kh // CHUNK
    span = -(-chunks // splits)
    w = unpack_planar(qt.packed).double() - qt.zero_points.double()[:, None]   # q - zp [N, K]
    xd = x.double()
    total = torch.zeros((m, qt.out_dim))
    for z in range(splits):
        part = torch.zeros((m, qt.out_dim))
        for c in range(z * span, min(chunks, (z + 1) * span)):
            for half in (0, kh):
                cols = slice(half + c * CHUNK, half + (c + 1) * CHUNK)
                part = part + (xd[:, cols] @ w[:, cols].t()).float()   # exact, rounded once
        total = total + part
    return qt.scales.float() * total


MODEL_CASES = [(200, 256, 1024, 1), (130, 128, 512, 2), (96, 384, 2048, 3), (65, 128, 2560, 5)]


@pytest.mark.parametrize("m,n,k,splits", MODEL_CASES)
def test_body_model_matches_plain_version(rng, m, n, k, splits):
    """The body's order (ranges of whole chunks, low then high half, the raw
    partials added in order, s[n] once) against the plain version."""
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)) * k ** -0.5
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    qt = quantize(w)
    y = body_model(x, qt, splits)
    ref = ops.int4_matmul_reference(x, qt)
    assert torch.max(torch.abs(y - ref)) <= 1e-3 * torch.max(torch.abs(ref))


@pytest.mark.parametrize("m,n,k,splits", MODEL_CASES)
def test_body_model_matches_jax_kernel(rng, m, n, k, splits):
    """The same model against the JAX package's K1 on the same bytes: the
    weight quantized by JAX, x at the bf16 values the body stages, both
    sides in f32."""
    w = rng.standard_normal((n, k)).astype(np.float32) * k ** -0.5
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).bfloat16().float()
    ref_qt = jax_quantize(jnp.asarray(w))
    qt = QuantizedTensor(torch.from_numpy(np.array(ref_qt.packed)),
                         torch.from_numpy(np.array(ref_qt.scales)),
                         torch.from_numpy(np.array(ref_qt.zero_points)), (n, k), block_k=k)
    y = body_model(x, qt, splits)
    want = torch.from_numpy(np.array(jax_int4_matmul(jnp.asarray(x.numpy()), ref_qt,
                                                     prefill_threshold=1 << 30)))
    assert torch.max(torch.abs(y - want)) <= 1e-3 * torch.max(torch.abs(want))


@pytest.mark.parametrize("m", [8, 64, 65, 200, K1_CELL_ROWS, im.PREFILL_THRESHOLD,
                               im.PREFILL_THRESHOLD + 1])
def test_k1_reaches_its_entry_points(stub, m):
    """What ``int4_matmul`` calls at M rows (CPU tensors taking the card's
    bodies, a stub library): bf16 at N=1024 the body's K1 entry from
    WG_MIN_LINEAR_ROWS up to PREFILL_THRESHOLD rows at the rule's launch,
    with an f32 partial where slices are cut into ranges; the tall or decode
    tile for the router (N=8) and for N off whole slices; f32 x the CUDA-core
    loop; above the threshold no kernel (dequantize + matmul). The
    ``int4_matmul_wg`` counter counts the body's launches alone."""
    k = 1024
    gen = torch.Generator().manual_seed(m)
    w = torch.randn((1024, k), generator=gen) * k ** -0.5
    x = torch.randn((m, k), generator=gen).bfloat16()
    dense = m > im.PREFILL_THRESHOLD
    wg = im.WG_MIN_LINEAR_ROWS <= m and not dense
    ops.reset_counts()
    for name, qt, xx, entry in (
            ("K1", quantize(w), x, _wg._ENTRIES["K1"] if wg else "f4b_int4_matmul_bf16"),
            ("router", quantize(w[:8]), x, "f4b_int4_matmul_bf16"),
            ("N=960", quantize(w[:960]), x, "f4b_int4_matmul_bf16"),
            ("f32", quantize(w), x.float(), "f4b_int4_matmul_f32")):
        stub.calls.clear()
        y = ops.int4_matmul(xx, qt)
        assert y.shape == (m, qt.out_dim)
        assert [e for e, _ in stub.calls] == ([] if dense else [entry]), name
        if wg and name == "K1":
            (_, args), = stub.calls
            full, splits, grid = _wg._wg_linear_launch(m, 1024, k, SMS, "K1")
            assert args[6:12] == (m, 1024, k, full, splits, grid)
            assert (args[5] is None) == (full == 8 * -(-m // 128))
    counts = ops.launch_counts()
    assert counts["int4_matmul_wg"] == int(wg)
    assert counts["int4_matmul"] == (0 if dense else 4)
