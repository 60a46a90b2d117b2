"""The tensor-core body of K1 and K6 (``csrc/int4_mma.cuh``), in what the CPU
can check: its register dequantization, modelled bit for bit in plain torch,
against the port's and the JAX package's weights; the launch rule
``ops._mma._mma_launch``; and K1's row threshold.

Tolerances: the dequantization model is held bit for bit. The threshold test
holds the port's plain version (bf16 and f32 activations, either side of the
threshold) to JAX's ``int4_matmul`` in interpret mode at 1e-3 of the largest
output in f32 and 2e-2 in bf16 (one bf16 rounding of each side).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from fused4bit_tpu.ops.int4_matmul import int4_matmul_per_group as jax_pg
from fused4bit_tpu.quant.core import quantize as jax_quantize
from fused4bit_tpu_torch.ops._mma import _MMA_TALL_M, _mma_launch, _mma_tall_launch
from fused4bit_tpu_torch.ops.int4_matmul import (
    int4_matmul,
    int4_matmul_reference,
    planar_pg_weight,
)
from fused4bit_tpu_torch.quant import QuantizedTensor, unpack_planar

BYTES = torch.arange(256, dtype=torch.int32)
ZPS = torch.arange(16, dtype=torch.float32)


def _bf16_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (16 bits) as bf16 values."""
    return bits.to(torch.int16).view(torch.bfloat16)


def mma_dequant(p: torch.Tensor, zp: torch.Tensor, s=None):
    """The kernel's dequantization of packed bytes ``p`` (int32 0..255) with
    zero points ``zp`` (and, for K6, f32 scales ``s``), operation by
    operation, as (lo, hi) bf16 tensors:

    * ``0x4300 | (p & 0xF)`` and ``0x4308 ^ (p >> 4 & 0xF)``, read as bf16,
      are 128 + lo and 128 + (hi XOR 8);
    * ``__hsub2`` of bf16(128 + zp): a bf16 subtraction, one rounding;
    * K6: ``__hmul2`` by bf16(s): a bf16 product, one rounding to nearest
      even (torch's bf16 arithmetic rounds the f32 result once, as the
      tensor instruction does)."""
    lo = _bf16_bits((p & 0xF) | 0x4300)
    hi = _bf16_bits(((p >> 4) & 0xF) ^ 0x4308)
    z = (128.0 + zp).to(torch.bfloat16)
    lo, hi = lo - z, hi - z
    if s is not None:
        sb = s.to(torch.bfloat16)
        lo, hi = lo * sb, hi * sb
    return lo, hi


def _k6_dequant(p: torch.Tensor, s: torch.Tensor, z: torch.Tensor, gs: int = 128):
    """K6's weights [N, K] from the register model: bytes p [N, K/2], scales
    and zero points [N, K/gs]; the byte at column c reads the low half's
    group c // gs for its low nibble and the high half's, Gh + c // gs, for
    its high nibble, as a lane does for its 16-byte run."""
    n, kh = p.shape
    g = (torch.arange(kh) // gs).expand(n, kh)
    lo, _ = mma_dequant(p, torch.gather(z, 1, g), torch.gather(s, 1, g))
    _, hi = mma_dequant(p, torch.gather(z, 1, kh // gs + g), torch.gather(s, 1, kh // gs + g))
    return lo, hi


def _grid():
    """Every byte value against every zero point: p, zp [16, 256]."""
    return BYTES[None, :].expand(16, 256), ZPS[:, None].expand(16, 256)


def test_k1_register_dequant_is_q_minus_zp():
    """K1: the two bf16 values of a byte are exactly (q - zp), q the codes the
    planar layout holds (low nibble, high nibble XOR 8), for all 256 bytes
    and all 16 zero points."""
    p, zp = _grid()
    lo, hi = mma_dequant(p, zp)
    codes = unpack_planar(p.to(torch.uint8)).float()          # [16, 512]: lo half, hi half
    want = (codes - ZPS[:, None]).to(torch.bfloat16)
    assert torch.equal(torch.cat([lo, hi], dim=1).view(torch.int16), want.view(torch.int16))
    assert torch.equal(lo.float(), ((p & 0xF) - zp).float())
    assert torch.equal(hi.float(), (((p >> 4) ^ 8) - zp).float())


# Scales in f32, not all bf16 values: the kernel and planar_pg_weight both
# round them to bf16 first. A sweep over magnitudes, with ties of the bf16
# rounding, subnormal-range and large values.
SCALE_SWEEPS = [
    np.geomspace(1e-4, 1.0, 64),
    np.linspace(0.001, 0.02, 64),
    1.0 + np.arange(64) * 2.0 ** -8,          # halfway cases of the bf16 rounding
    np.geomspace(1e-30, 1e30, 64),
]


@pytest.mark.parametrize("sweep", range(len(SCALE_SWEEPS)))
def test_k6_register_dequant_equals_planar_pg_weight(sweep, rng):
    """K6: ``bf16(bf16(s) * (q - zp))`` from the register model equals
    ``planar_pg_weight`` (K6's plain version) bit for bit, for all 256 bytes
    x 16 zero points, each row of bytes under 4 groups of 128 columns with
    scales from the sweep."""
    p, _ = _grid()                                         # 16 rows, K/2 = 256 bytes
    s = torch.from_numpy(rng.permutation(np.asarray(SCALE_SWEEPS[sweep], np.float32))
                         .reshape(16, 4))
    z = torch.from_numpy(rng.integers(0, 16, (16, 4)).astype(np.float32))
    z[:, 0] = z[:, 3] = ZPS                                # every zero point in both halves
    got = torch.cat(_k6_dequant(p, s, z), dim=1)
    want = planar_pg_weight(p.to(torch.uint8), s, z, 128, torch.bfloat16)
    assert torch.equal(got.float(), want)


def test_k6_register_dequant_equals_jax_kernel_weights(rng):
    """The register model's K6 weights equal JAX's interpret-mode K6 weights:
    JAX's ``int4_matmul_per_group`` on one-hot bf16 rows returns each weight
    column exactly (one product, summed in f32, rounded to bf16 once)."""
    n, k = 16, 512
    w = rng.standard_normal((n, k)).astype(np.float32) * k ** -0.5
    ref = jax_quantize(jnp.asarray(w), granularity="per_group", layout="planar", group_size=128)
    cols = np.asarray(jax_pg(jnp.eye(k, dtype=jnp.bfloat16), ref).astype(jnp.float32))  # [K, N]
    p = torch.from_numpy(np.array(ref.packed)).to(torch.int32)
    s, z = torch.from_numpy(np.array(ref.scales)), torch.from_numpy(np.array(ref.zero_points))
    assert np.array_equal(torch.cat(_k6_dequant(p, s, z), dim=1).float().numpy(), cols.T)


# --- the launch rule -------------------------------------------------------------

SMS = 132  # the H100's SMs
# The K1/K6 linears of `layer2` (hidden 4096, 32/8 heads of 128, 8 experts,
# vocab 8192): q and o, k and v, the INT4 router, the LM head.
LAYER2_LINEARS = [(4096, 4096), (1024, 4096), (8, 4096), (8192, 4096)]


def test_mma_launch_reads_n_k_and_sms_only():
    """No M among the rule's inputs: every row's sum runs in one order at
    every M up to the tall tile's threshold, so rows are M-independent."""
    assert list(inspect.signature(_mma_launch).parameters) == ["n", "k", "sms"]
    assert _MMA_TALL_M >= 40          # the self-draft verify forward (8 x 5 rows) included
    assert _mma_launch(4096, 4096, SMS) == _mma_launch(4096, 4096, SMS)


@pytest.mark.parametrize("n,k", LAYER2_LINEARS + [(14336, 4096), (4096, 14336), (384, 512),
                                                  (8, 256), (96, 160)])
def test_mma_launch_fills_the_card(n, k):
    """At least one warp of work per SM at every layer2 shape (N=1024 and the
    N=8 router included), and a launch the kernel accepts: kw a power of two
    dividing 8, a CTA's range whole chunks of 8 k steps and at most 256 steps
    (its 16 staged rows of x within 132 KB), ws > 32 never with kw > 1, and
    splits that cover K with no CTA beyond it."""
    ws, kw, splits = _mma_launch(n, k, SMS)
    tiles = -(-n // 16)
    steps = 8 * -(-(k // 2) // 64)
    warps = tiles * -(-steps // ws)        # warps with k steps to run
    if (n, k) in LAYER2_LINEARS:
        assert warps >= SMS
    assert kw in (1, 2, 4, 8) and 1 <= ws <= 32
    assert (kw * ws) % 8 == 0 and kw * ws <= 256
    assert (splits - 1) * kw * ws < steps <= splits * kw * ws


@pytest.mark.parametrize("n", [4096, 1024, 8, 8192])
@pytest.mark.parametrize("m", [65, 128, 640])
def test_mma_tall_launch_covers_k_in_whole_stages(n, m):
    """Above 64 rows: one warp per row tile along K (kw 1) in stages of 32 k
    steps, K split across CTAs only until every SM has one, and splits that
    cover K with no CTA beyond it."""
    ws, kw, splits = _mma_tall_launch(n, 4096, m, SMS)
    steps = 8 * -(-(4096 // 2) // 64)
    ctas = -(-n // 128) * -(-m // 64)
    assert kw == 1 and ws % 32 == 0
    assert (splits - 1) * ws < steps <= splits * ws
    assert splits == 1 or ctas * (splits - 1) < SMS


# --- K1's row threshold ------------------------------------------------------------

THRESHOLD = inspect.signature(int4_matmul).parameters["prefill_threshold"].default


def test_k1_threshold_keeps_the_verify_forward_on_the_kernel():
    """Every self-draft verify forward (8 slots x (gamma + 1) rows, 40 at
    gamma 4) stays on K1."""
    assert THRESHOLD >= 40


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", [0, 1])
def test_int4_matmul_matches_jax_either_side_of_the_threshold(rng, side, dtype):
    """At the threshold (the kernel's plain version on the CPU) and one row
    above it (dequantize, then a dense matmul), against JAX's int4_matmul."""
    m, n, k = THRESHOLD + side, 48, 256
    w = rng.standard_normal((n, k)).astype(np.float32) * k ** -0.5
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref_qt = jax_quantize(jnp.asarray(w))
    qt = QuantizedTensor(torch.from_numpy(np.array(ref_qt.packed)),
                         torch.from_numpy(np.array(ref_qt.scales)),
                         torch.from_numpy(np.array(ref_qt.zero_points)), (n, k), block_k=k)
    before = int4_matmul_reference.calls
    y = int4_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), qt)
    assert int4_matmul_reference.calls == before + (1 - side)
    ref = np.asarray(jax_int4_matmul(jnp.asarray(x, dtype), ref_qt).astype(jnp.float32))
    tol = {"float32": 1e-3, "bfloat16": 2e-2}[dtype]
    assert y.shape == (m, n)
    assert np.max(np.abs(y.float().numpy() - ref)) <= tol * np.max(np.abs(ref))
