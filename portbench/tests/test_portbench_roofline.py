"""Operations and bytes against counts by hand at tiny shapes."""
import pytest

from portbench import roofline
from portbench.inputs import ModelSpec


def test_linear_per_row():
    w = roofline.linear(3, 8, 16)
    assert w.flops == 2 * 3 * 8 * 16
    # packed 8*16/2, scale+zp 8*8, x 3*16*2, y 3*8*2
    assert w.bytes == 64 + 64 + 96 + 48


def test_linear_per_group():
    w = roofline.linear(1, 4, 256, "per_group", 128)
    assert w.bytes == 4 * 128 + 8 * 4 * 2 + 2 * 256 + 2 * 4


def test_grouped_counts_only_experts_hit():
    w = roofline.grouped([3, 0, 1, 0], n=8, k=16)
    assert w.flops == 2 * 4 * 8 * 16
    assert w.bytes == 2 * (64 + 64) + 2 * 4 * (16 + 8)


def test_attention():
    w = roofline.attention([5, 7], heads=4, kv_heads=2, head_dim=8)
    assert w.flops == 4 * 4 * 8 * 12
    assert w.bytes == 2 * 12 * (8 + 16) + 2 * 2 * 2 * 4 * 8


def test_decode_step_sums_its_families():
    spec = ModelSpec(hidden=16, ffn=32, layers=2, heads=2, kv_heads=1, head_dim=8, experts=4,
                     top_k=2, vocab=10, rope_theta=1e4, rms_eps=1e-5)
    tpe = [[2, 0, 1, 1], [4, 0, 0, 0]]
    fam = roofline.decode_step(spec, 2, [3, 3], tpe)
    lin = roofline.linear(2, 16, 16).bytes * 2 + roofline.linear(2, 8, 16).bytes * 2 \
        + roofline.linear(2, 4, 16).bytes
    assert fam["int4_matmul"].bytes == pytest.approx(2 * lin + roofline.linear(2, 10, 16).bytes)
    # gate and up: 512 weight bytes an expert, down 384; each of the three
    # moves 2 bytes x 4 routed rows x (K + N) = 384 of activations
    hit = 3 + 1
    assert fam["grouped_matmul"].bytes == hit * (512 + 512 + 384) + 2 * 3 * 384
    total = sum(fam[k].bytes for k in ("int4_matmul", "grouped_matmul", "decode_attention"))
    assert fam["step"].bytes == pytest.approx(total + 2 * 2 * 2 * 1 * (4 + 8) + 2 * 16 * 2)
    assert fam["step"].bound_s() >= fam["grouped_matmul"].bound_s()


def test_model_and_cache_bytes_by_hand():
    """8x7B per row: a layer's q/o (4096 x 4096) and k/v (1024 x 4096) at
    half a byte a weight and 8 bytes a row, its router (8 rows), 8 experts'
    gate and up (14336 x 4096) and down (4096 x 14336), two bf16 norms;
    then the bf16 embedding and final norm and the INT4 lm_head."""
    from portbench import registry
    from portbench.inputs import ModelSpec
    spec = ModelSpec.from_config(registry.config("mixtral-8x7b"))

    def w(n, k):
        return n * k // 2 + 8 * n
    layer = (2 * w(4096, 4096) + 2 * w(1024, 4096) + w(8, 4096)
             + 8 * (2 * w(14336, 4096) + w(4096, 14336)) + 2 * 4096 * 2)
    whole = 32 * layer + 32000 * 4096 * 2 + 4096 * 2 + w(32000, 4096)
    assert roofline.model_bytes(spec) == whole
    assert roofline.kv_bytes_per_position(spec) == 32 * 8 * (128 + 16)
