"""K8, the w4a8 per-group linear, on the int8 tensor-core body
(``csrc/int8_mma.cuh``, K14's body run as a one-expert stack) in what the CPU
can check: its plain version against the JAX package's
``int4_matmul_per_group_a8`` in interpret mode, the independence of a row's
bits from the M of the call, the launch rule as a pure function of (N, K,
gs, SMs), and the body choice by the group size.

The plain version repeats the body's order of f32 sums at the launch rule's
shape (``_pg_a8_fold_product``: one fold per group, in group order, the warps
along K added in order), so on the card the kernel must equal it bit for bit
(``chip_smoke.check_linear_pg``).

Tolerances: against JAX, A8_TOL of ``test_torch_per_group.py``: the same
quantizer and exact integer partials, the f32 terms summed in another order
(JAX adds the c.X terms of every group first, then the a.P terms).
"""
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.ops.int4_matmul import int4_matmul_per_group_a8 as jax_pg_a8
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.ops._int8 import _i8_chunk, _linear_a8_launch, _pg_a8_fold_product
from fused4bit_tpu_torch.ops._rows import _pg_a8_product
from fused4bit_tpu_torch.ops.int8_xla import _quantize_acts
from fused4bit_tpu_torch.quant import quantize
from test_torch_per_group import A8_TOL, _TORCH, _assert_close, _jax_pg, _port_qt

im = importlib.import_module("fused4bit_tpu_torch.ops.int4_matmul")

SMS = 132                  # the H100's SMs, which the plain version assumes on the CPU
N, KDIM = 384, 1024        # N > 256; K/2 = 512 = 4 groups of 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 8, 40])
def test_k8_plain_version_matches_jax(rng, m, dtype):
    """The wrapper on a CPU tensor (K8's plain version) against JAX's K8 in
    interpret mode on the same bytes, within A8_TOL; it is the int8 body's
    fold at the launch rule's shape, bit for bit."""
    w = rng.standard_normal((N, KDIM)).astype(np.float32) * KDIM ** -0.5
    x = rng.standard_normal((m, KDIM)).astype(np.float32)
    ref_qt = _jax_pg(w)
    qt = _port_qt(ref_qt)
    xt = torch.from_numpy(x).to(_TORCH[dtype])
    before = ops.int4_matmul_per_group_a8_reference.calls
    y = ops.int4_matmul_per_group_a8(xt, qt)
    assert ops.int4_matmul_per_group_a8_reference.calls == before + 1
    assert y.dtype == _TORCH[dtype] and y.shape == (m, N)
    _assert_close(y, jax_pg_a8(jnp.asarray(x).astype(dtype), ref_qt), A8_TOL[dtype])
    xq, sx = _quantize_acts(xt, fused=True)
    fold = _pg_a8_fold_product(xq, sx, qt.packed, qt.scales, qt.zero_points,
                               launch=_linear_a8_launch(N, KDIM, 128, SMS))
    assert torch.equal(y, fold.to(_TORCH[dtype]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8_rows_do_not_depend_on_m(rng, dtype):
    """Rows 0-7 of a 40-row call equal the 8-row call bit for bit (the
    self-draft verify's rows), and a zero row gives exactly 0 wherever it
    sits (the kernel writes the rows after a block's last row in use as 0
    and computes a zero row among them as 0)."""
    qt = quantize(torch.from_numpy(rng.standard_normal((N, KDIM)).astype(np.float32)),
                  granularity="per_group", layout="planar_groups", group_size=128)
    x40 = torch.from_numpy(rng.standard_normal((40, KDIM)).astype(np.float32)).to(_TORCH[dtype])
    x40[3] = 0
    x40[39] = 0
    y8, y40 = ops.int4_matmul_per_group_a8(x40[:8], qt), ops.int4_matmul_per_group_a8(x40, qt)
    assert torch.equal(y8, y40[:8])
    assert not torch.any(y40[3]) and not torch.any(y40[39])


@pytest.mark.parametrize("n, k, gs, want", [
    (4096, 4096, 128, (4, 8, 1)),      # layer2 q and o
    (1024, 4096, 128, (4, 8, 1)),      # k and v
    (8192, 4096, 128, (8, 4, 1)),      # the lm_head
    (4096, 4096, 64, (4, 8, 1)),       # gs 64: one 64-byte chunk a group
    (4096, 4096, 32, (8, 8, 1)),       # gs 32: 32-byte chunks
    (512, 256, 128, (2, 1, 1)),        # the h256 fixture's q: one group per half
    (N, KDIM, 128, (2, 4, 1)),         # this file's shape
])
def test_k8_launch_rule_reads_no_m(n, k, gs, want):
    """``_linear_a8_launch`` is a pure function of (N, K, gs, SMs): no M
    reaches it, so a row's sums run in one order at every M. Whole groups
    per warp, no more warps along K than groups, no split of K over CTAs,
    and every chunk of K/2 covered."""
    assert list(inspect.signature(_linear_a8_launch).parameters) == ["n", "k", "gs", "sms"]
    ws, kw, splits = _linear_a8_launch(n, k, gs, SMS)
    assert (ws, kw, splits) == want
    groups = (k // 2) // gs
    unit = gs // _i8_chunk(gs)
    assert kw in (1, 2, 4, 8) and kw <= groups and splits == 1
    assert ws % unit == 0 and kw * ws >= groups * unit > (kw - 1) * ws


def test_k8_body_choice_reads_the_group_size_only(rng):
    """K8 takes the int8 body at gs % 32 == 0, the CUDA-core loop at the
    other multiples of 16, by the group size alone (as K14); its plain
    version follows: the per-run fold of the CUDA-core loop at gs 16, the
    int8 body's per-group fold at gs 32."""
    for dtype in (torch.bfloat16, torch.float32):
        for m in (8, 640):
            assert [im._body("K8", True, dtype, gs, m, N, KDIM)
                    for gs in (16, 32, 48, 64, 96, 128, 256)] == [
                "rows", "int8", "rows", "int8", "int8", "int8", "int8"]
    w = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((5, 512)).astype(np.float32))
    xq, sx = _quantize_acts(x, fused=True)
    for gs, product in ((16, _pg_a8_product),
                        (32, lambda *a: _pg_a8_fold_product(
                            *a, launch=_linear_a8_launch(64, 512, 32, SMS)))):
        qt = quantize(w, granularity="per_group", layout="planar_groups", group_size=gs)
        want = product(xq, sx, qt.packed, qt.scales, qt.zero_points)
        assert torch.equal(ops.int4_matmul_per_group_a8(x, qt), want)
