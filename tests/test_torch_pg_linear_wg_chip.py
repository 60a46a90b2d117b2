"""K7's tall calls on the warpgroup body (``csrc/grouped_wgmma.cu``) on the
card: against the plain version at the per-group cells' linear shapes, two
launches bit-equal, and the calls the body does not take (64 rows, N in no
whole slices of 128) bit-equal to the launch they always had. Skips without a
CUDA card. On the card, from the repository's root:

    python3 -m pytest tests/test_torch_pg_linear_wg_chip.py -m chip -q

``chip_smoke.check_pg_linear_wg`` runs the same shapes with device times.
Imports nothing of JAX.
"""
import pytest
import torch

from chip_smoke import BF16_REL_TOL, PG_LINEAR_SHAPES
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.ops import _mma
from fused4bit_tpu_torch.quant import quantize

# (M, N, K): K-EXAONE-236B's K7 linears at 896 rows, Mixtral-8x22B's at 384
CELL_SHAPES = [(m, n, k) for m, shapes in PG_LINEAR_SHAPES.items() for n, k in shapes]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the warpgroup body has no CPU path")
    return torch.device("cuda", 0)


def _weights(n, k, gen, device):
    w = torch.randn((n, k), generator=gen, device=device) * k ** -0.5
    return quantize(w, granularity="per_group", layout="planar_groups", group_size=128)


@pytest.mark.chip
@pytest.mark.parametrize("m,n,k", CELL_SHAPES)
def test_wg_body_matches_plain_version_and_repeats_its_bits(card, m, n, k):
    """At the cell's rows and at a ragged 200: the wrapper takes the body,
    matches the plain version within the bf16 bar, and a second launch on
    the same inputs gives the same bits."""
    gen = torch.Generator(device=card).manual_seed(n + k)
    qt = _weights(n, k, gen, card)
    for rows in (m, 200):
        x = torch.randn((rows, k), generator=gen, device=card).bfloat16()
        before = ops.int4_matmul_per_group.wg_launches
        y = ops.int4_matmul_per_group(x, qt)
        again = ops.int4_matmul_per_group(x, qt)
        ref = ops.int4_matmul_per_group_reference(x, qt)
        torch.cuda.synchronize()
        assert ops.int4_matmul_per_group.wg_launches == before + 2
        assert torch.isfinite(y).all()
        assert torch.equal(y, again)
        err = (y.float() - ref.float()).abs().max().item()
        assert err <= BF16_REL_TOL * ref.float().abs().max().item(), (rows, err)


@pytest.mark.chip
@pytest.mark.parametrize("m,n,k", [(64, 1024, 6144), (64, 8192, 6144), (384, 960, 6144)])
def test_calls_off_the_body_keep_their_launch_bits(card, m, n, k):
    """64 rows (decode's tile) and a width in no whole slices of 128 (the tall
    tile at 384 rows) do not take the body, and equal the launch they always
    had (``_mma._launch`` at the decode or tall shape) bit for bit."""
    gen = torch.Generator(device=card).manual_seed(k - n)
    qt = _weights(n, k, gen, card)
    x = torch.randn((m, k), generator=gen, device=card).bfloat16()
    before = ops.int4_matmul_per_group.wg_launches
    y = ops.int4_matmul_per_group(x, qt)
    old = _mma._launch(x, qt, "K7")
    torch.cuda.synchronize()
    assert ops.int4_matmul_per_group.wg_launches == before
    assert torch.equal(y, old)
