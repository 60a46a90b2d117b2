"""The decode mix's inputs: the same seed gives the same cache and first
tokens, another seed others; a block of cached rows is drawn alone; the
batch fills the card by the mix's rule; and the compared numbers see a
fault confined to one sequence."""
import pytest
import torch

from portbench import correct, inputs, registry, roofline
from portbench.drivers import decode
from portbench.inputs import ModelSpec
from portbench.tests import tiny

MIX = registry.traffic("offline_isl2k")
SPEC = ModelSpec.from_config(tiny.TINY)


def _kv(seed, rows, layer=0):
    return inputs.prefix_kv(SPEC, seed, layer, rows, 8, 1.0, "cpu")


def test_same_seed_same_cache():
    a, b = _kv(2**31 + 5, range(0, 70)), _kv(2**31 + 5, range(0, 70))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = _kv(2**31 + 6, range(0, 70))
    assert not torch.equal(a[0], c[0])


def test_a_block_is_drawn_alone():
    whole = _kv(7, range(0, 130))
    block = _kv(7, range(64, 128))
    assert torch.equal(whole[0][64:128], block[0]) and torch.equal(whole[1][64:128], block[1])
    with pytest.raises(ValueError):
        _kv(7, range(3, 10))


def test_layers_and_keys_differ():
    k0, v0 = _kv(7, range(0, 4), layer=0)
    k1, _ = _kv(7, range(0, 4), layer=1)
    assert not torch.equal(k0, v0) and not torch.equal(k0, k1)


@pytest.mark.parametrize("name,expected", [("mixtral-8x7b", 576),
                                           ("mixtral-8x22b-pg128", 384)])
def test_batch_fills_the_card(name, expected):
    """By hand: 8x7B's weights 23.62 GB and 36,864 cache bytes a position
    (32 layers x 8 KV heads x (128 code bytes + 16 plane bytes)), 8x22B
    pg128's 39.94 GB and 32,256; 0.9 x 85.52 GB - weights - 6 GB over
    2176 positions is 590 and 442 sequences, down to multiples of 64."""
    spec = ModelSpec.from_config(registry.config(name))
    assert decode.batch(spec, MIX) == expected
    per_seq = roofline.kv_bytes_per_position(spec) * 2176
    fill = MIX["batch_fill"]
    room = fill["utilization"] * fill["card_bytes"] - roofline.model_bytes(spec)
    assert expected * per_seq <= room - fill["reserve_bytes"] < (expected + 64) * per_seq


def test_one_sequence_at_fault_shows():
    """At the 8x7B cell's batch, one sequence of 32 tokens wrong by 4 logits
    moves the mean gap by 0.007 and the worst sequence's to 4."""
    gaps = torch.full((576, 32), 0.012)
    gaps[100] = 4.0
    got = correct.compared(gaps, 0.0)
    assert got["mean_logit_gap"] < 0.02
    assert abs(got["worst_seq_logit_gap"] - 4.0) < 1e-6
