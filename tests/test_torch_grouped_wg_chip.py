"""K2 and K13 on the warpgroup body (``csrc/grouped_wgmma.cu``) on the card:
against their plain versions, and a token's rows the same bits at every
tile_m and routing within the body's domain. Skips without a CUDA card. On
the card, from the repository's root:

    python3 -m pytest tests/test_torch_grouped_wg_chip.py -m chip -q

Shapes are the benchmark cells' widths cut in depth (8 experts, N and K as
Mixtral-8x22B's and 8x7B's experts' but fewer output features), so a call
builds and runs in seconds. ``chip_smoke.check_grouped_wg`` runs the full
widths. Imports nothing of JAX.
"""
import pytest
import torch

from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.layers import dispatch, make_dispatch_plan, topk_route
from fused4bit_tpu_torch.ops import grouped_matmul as gm
from fused4bit_tpu_torch.quant import quantize

E = 8
# (kernel, N, K): K13 per group of 128 at Mixtral-8x22B's K (gate/up 6144,
# down 16384), K2 at Mixtral-8x7B's (4096, 14336), N cut to 1024
CASES = [("K13", 1024, 6144), ("K13", 1024, 16384), ("K2", 1024, 4096), ("K2", 1024, 14336)]
BF16_REL_TOL = 1e-2   # chip_smoke's w4a16 bar: of the largest output


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the warpgroup body has no CPU path")
    return torch.device("cuda", 0)


def _weights(kernel, n, k, gen, device):
    w = torch.randn((E, n, k), generator=gen, device=device) * k ** -0.5
    if kernel == "K13":
        return quantize(w, granularity="per_group", layout="planar_groups", group_size=128)
    return quantize(w)


def _op(kernel):
    if kernel == "K13":
        return ops.grouped_int4_matmul_per_group, ops.grouped_int4_matmul_per_group_reference
    return ops.grouped_int4_matmul, ops.grouped_int4_matmul_reference


def _logits(t, gen, device, skew):
    bias = torch.log(1.0 / (torch.arange(E, device=device) + 1.0)) * skew
    return bias[None, :] + torch.randn((t, E), generator=gen, device=device)


def _routing(t, gen, device, skew):
    return topk_route(_logits(t, gen, device, skew), 2, E)


@pytest.mark.chip
@pytest.mark.parametrize("skew", [0.0, 4.0])
@pytest.mark.parametrize("kernel,n,k", CASES)
def test_wg_body_matches_plain_version(card, kernel, n, k, skew):
    """At 384 tokens (T_pad 896 at tile_m 16) and 576 (T_pad 2176 at tile_m
    128), spread and skewed routing (one expert past 256 rows, some with
    none): the wrapper takes the warpgroup body, matches its plain version
    within the bf16 bar, and writes the zero padding rows as exactly 0."""
    gen = torch.Generator(device=card).manual_seed(n + k)
    qt = _weights(kernel, n, k, gen, card)
    op, plain = _op(kernel)
    for t, tile_m in ((384, 16), (576, 128)):
        routing = _routing(t, gen, card, skew)
        loads = routing.tokens_per_expert.tolist()
        assert not skew or (max(loads) > 256 and min(loads) == 0), loads
        plan = make_dispatch_plan(routing, E, tile_m=tile_m)
        assert gm._body(kernel, True, torch.bfloat16, qt.group_size, plan.t_pad, E, tile_m,
                        n, k) == "wg"
        xs = dispatch(torch.randn((t, k), generator=gen, device=card).bfloat16(), routing, plan)
        before = op.wg_launches
        y = op(xs, plan.tile_group_ids, qt, tile_m=tile_m)
        ref = plain(xs, plan.tile_group_ids, qt, tile_m=tile_m)
        torch.cuda.synchronize()
        assert op.wg_launches == before + 1
        assert torch.isfinite(y).all()
        pad = xs.abs().sum(dim=1) == 0
        assert bool((y[pad] == 0).all())
        err = (y.float() - ref.float()).abs().max().item()
        assert err <= BF16_REL_TOL * ref.float().abs().max().item(), (t, tile_m, err)


@pytest.mark.chip
@pytest.mark.parametrize("kernel,n,k", CASES)
def test_wg_token_rows_same_bits_across_tile_m_and_routing(card, kernel, n, k):
    """One skewed routing of 384 tokens at tile_m 16, 32, 64 and 128 (T_pad
    896-1792), and its first 64 tokens again beside 320 tokens routed by
    another draw: every token's rows are the same bits, though they sit in
    other rows, runs and passes."""
    gen = torch.Generator(device=card).manual_seed(k)
    qt = _weights(kernel, n, k, gen, card)
    op, _ = _op(kernel)
    x = torch.randn((384, k), generator=gen, device=card).bfloat16()
    logits = _logits(384, gen, card, 4.0)
    routing = topk_route(logits, 2, E)
    got = []
    for tile_m in (16, 32, 64, 128):
        plan = make_dispatch_plan(routing, E, tile_m=tile_m)
        assert plan.t_pad - E * tile_m >= E * gm.WG_MIN_EXPERT_ROWS
        got.append(op(dispatch(x, routing, plan), plan.tile_group_ids, qt,
                      tile_m=tile_m)[plan.rows])
    for y in got[1:]:
        assert torch.equal(got[0], y)
    mixed = torch.cat([logits[:64], _logits(320, gen, card, 0.0)])
    other = topk_route(mixed, 2, E)
    plan = make_dispatch_plan(other, E, tile_m=16)
    y = op(dispatch(x, other, plan), plan.tile_group_ids, qt, tile_m=16)[plan.rows]
    assert torch.equal(y[:128], got[0][:128])      # the first 64 tokens' top-2 pairs
