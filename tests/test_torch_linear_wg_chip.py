"""K1's tall calls on the warpgroup body (``csrc/grouped_wgmma.cu``,
``int4_mma_kernel_wg<RowScale, false>``) on the card: against the plain
version at Mixtral-8x7B's linear shapes at its cell's 576 rows and at 65,
two replays of a CUDA graph bit-equal to the eager call, a launch that cuts
slices into ranges of K among them; and the calls the body does not take
(64 rows, the router's N=8, N in no whole slices of 128) bit-equal to the
launch they always had. Skips without a CUDA card. On the card, from the
repository's root:

    python3 -m pytest tests/test_torch_linear_wg_chip.py -m chip -q

``chip_smoke.check_linear_wg`` runs the same shapes with device times.
Imports nothing of JAX.
"""
import pytest
import torch

from chip_smoke import K1_CELL_ROWS, K1_LINEAR_SHAPES, _a16_tol, _replays
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.ops import _front, _mma, _wg
from fused4bit_tpu_torch.ops.int4_matmul import PREFILL_THRESHOLD, WG_MIN_LINEAR_ROWS
from fused4bit_tpu_torch.quant import quantize

# (M, N, K): Mixtral-8x7B's K1 linears on the body at 576 and 65 rows
CASES = [(m, n, k) for n, k in K1_LINEAR_SHAPES for m in (K1_CELL_ROWS, WG_MIN_LINEAR_ROWS)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the warpgroup body has no CPU path")
    return torch.device("cuda", 0)


def _weights(n, k, gen, device):
    return quantize(torch.randn((n, k), generator=gen, device=device) * k ** -0.5)


@pytest.mark.chip
@pytest.mark.parametrize("m,n,k", CASES)
def test_wg_body_matches_plain_version_and_replays_its_bits(card, m, n, k):
    """The wrapper takes the body, matches the plain version within the bf16
    bar, and two replays of a graph that captured it give its bits."""
    gen = torch.Generator(device=card).manual_seed(m + n + k)
    qt = _weights(n, k, gen, card)
    x = torch.randn((m, k), generator=gen, device=card).bfloat16()
    before = ops.int4_matmul.wg_launches
    y = ops.int4_matmul(x, qt)
    assert ops.int4_matmul.wg_launches == before + 1
    first, second = _replays(lambda: ops.int4_matmul(x, qt))
    ref = ops.int4_matmul_reference(x, qt)
    assert torch.isfinite(y).all()
    assert torch.equal(y, first) and torch.equal(y, second)
    err = (y.float() - ref.float()).abs().max().item()
    assert err <= _a16_tol(ref), (m, n, err)


@pytest.mark.chip
def test_a_cell_shape_cuts_slices_into_ranges(card):
    """The 8x7B cell's k and v (40 items at 576 rows) run ranges of K whose
    partials the second pass adds, and still match the plain version."""
    m, n, k = K1_CELL_ROWS, 1024, 4096
    full, splits, _ = _wg._wg_linear_launch(m, n, k, _front._sm_count(card.index), "K1")
    assert full == 0 and splits > 1
    gen = torch.Generator(device=card).manual_seed(7)
    qt = _weights(n, k, gen, card)
    x = torch.randn((m, k), generator=gen, device=card).bfloat16()
    y = ops.int4_matmul(x, qt)
    ref = ops.int4_matmul_reference(x, qt)
    assert (y.float() - ref.float()).abs().max().item() <= _a16_tol(ref)


@pytest.mark.chip
@pytest.mark.parametrize("m,n,k", [(64, 4096, 4096), (K1_CELL_ROWS, 8, 4096),
                                   (K1_CELL_ROWS, 960, 4096)])
def test_calls_off_the_body_keep_their_launch_bits(card, m, n, k):
    """64 rows (decode's tile), the router's width and a width in no whole
    slices of 128 do not take the body, and equal the launch they always had
    (``_mma._launch`` at the decode or tall shape) bit for bit."""
    assert m <= PREFILL_THRESHOLD
    gen = torch.Generator(device=card).manual_seed(k - n)
    qt = _weights(n, k, gen, card)
    x = torch.randn((m, k), generator=gen, device=card).bfloat16()
    before = ops.int4_matmul.wg_launches
    y = ops.int4_matmul(x, qt)
    old = _mma._launch(x, qt, "K1")
    torch.cuda.synchronize()
    assert ops.int4_matmul.wg_launches == before
    assert torch.equal(y, old)
