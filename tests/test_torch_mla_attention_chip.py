"""K15 (multi-head latent attention over the INT4 latent cache) on the card,
against the same sum in plain torch (``ops.mla_attention_reference`` on the
same card), at the DeepSeek-V3 cell's shapes: 256 sequences of 2048-2080
positions, 128 heads, a latent of 512 and a RoPE key of 64. The checks are
chip_smoke.py's own (``check_mla_*``), which its phase 3 runs too. Skips
without a CUDA card. On the card, from the repository's root:

    python3 -m pytest tests/test_torch_mla_attention_chip.py -m chip -q -s

Imports nothing of JAX.
"""
import pytest
import torch

from chip_smoke import (
    Timer,
    check_mla_absorption,
    check_mla_cell,
    check_mla_prefill_rows,
    check_mla_ragged,
    mla_model_launches,
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K15 has no CPU path")
    return torch.device("cuda", 0)


@pytest.mark.chip
def test_k15_at_the_cell_shapes_matches_plain_torch_and_repeats_bit_for_bit(card):
    """Timed beside its bound, its plain version and the SDPA yardstick
    over the latent dequantized to bf16."""
    (row,) = check_mla_cell(card, Timer(card))
    assert row["library_ms"] is not None and row["ms"] > 0
    print(f"K15 {row['shape']}: {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({100 * row['bound_ms'] / row['ms']:.1f} % of its roofline), plain "
          f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms, "
          f"{torch.cuda.get_device_name(card)}")


@pytest.mark.chip
def test_k15_over_a_ragged_batch_of_two_segments(card):
    """Lengths 1-4095 over a cache of 4096: two segments, merged in order."""
    check_mla_ragged(card)


@pytest.mark.chip
def test_k15_prefill_rows_equal_decode_rows_bit_for_bit(card):
    """A chunk of 4 queries a row against the plain version, and each of its
    rows equal to a decode call at that position (the segments do not
    depend on T or on the lengths)."""
    check_mla_prefill_rows(card)


@pytest.mark.chip
def test_the_absorption_at_the_cell_shapes_matches_its_plain_versions(card):
    """W_UK^T (per row, K2) and W_UV (per group of 128, K13) over 256 rows
    a head, with the 128 heads as the grouped matmul's groups."""
    check_mla_absorption(card)


@pytest.mark.chip
def test_a_decode_step_of_the_main_path_launches_k15_once_a_layer(card):
    launches = mla_model_launches(card)
    assert launches["mla_attention"] == 3
