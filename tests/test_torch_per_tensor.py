"""Port vs JAX package: per_tensor weights and the interchange layouts in
the layers, the MoE modules and the conversion, ``padded_for_kernel``,
``nbytes``, the routing simulator and ``model_from_jax``'s new formats.

Every format no kernel takes runs the golden path (dequantize, then a
float32 matmul), as in JAX, through a counted plain version. Tolerances are
the port's existing ones (``test_torch_per_group``): the golden path to
1e-5 (f32) and 1e-2 (bf16) of the largest output, the integer-GEMM paths to
1e-6 (f32) and one bf16 ulp, 2^-7 (bf16); logits as the other model tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.layers import moe as jax_moe
from fused4bit_tpu.layers.linear import DenseLinear as JaxDenseLinear
from fused4bit_tpu.layers.linear import QuantizedLinear as JaxQuantizedLinear
from fused4bit_tpu.models import transformer as jax_transformer
from fused4bit_tpu.models.config import flagship_model_config as jax_flagship
from fused4bit_tpu.models.convert import convert_checkpoint as jax_convert_checkpoint
from fused4bit_tpu.quant import core as jq
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.layers import (
    DenseLinear,
    MoEINT4,
    QuantizedLinear,
    QuantizedMoE,
    dispatch,
    make_dispatch_plan,
    simulate_router_logits,
    topk_route,
)
from fused4bit_tpu_torch.models import (
    MoEBlock,
    as_xla_turbo,
    convert_checkpoint,
    flagship_model_config,
    model_from_jax,
)
from fused4bit_tpu_torch.ops.int8_xla import ROW_MULTIPLE
from fused4bit_tpu_torch.quant import dequantize, quantize
from test_torch_convert import H256, _assert_same_module, _configs, _random_checkpoint
from test_torch_model import _params, _prefill_and_decode_match
from test_torch_moe import _jax_mode, _port_mode
from test_torch_per_group import A8_TOL, A16_TOL, _assert_close, _port_qt

GOLDEN = (ops.int4_matmul_reference, ops.int4_matmul_per_group_reference,
          ops.grouped_int4_matmul_reference, ops.grouped_int4_matmul_per_group_reference)
PATHS = (ops.int4_linear_transient, ops.int4_grouped_transient)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: several test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _calls():
    return {fn.__name__: fn.calls for fn in GOLDEN + PATHS}


def _ran(before):
    after = _calls()
    return sorted(k for k in after if after[k] != before[k])


# (granularity, layout, group_size, block_k, use_kernel, the plain version that runs)
GOLDEN_FORMATS = [
    ("per_tensor", "planar", 128, None, True, "int4_matmul_reference"),
    ("per_tensor", "interleaved", 128, None, True, "int4_matmul_reference"),
    ("per_row", "interleaved", 128, None, True, "int4_matmul_reference"),
    ("per_row", "block_planar", 128, 64, True, "int4_matmul_reference"),
    ("per_group", "block_planar", 64, None, True, "int4_matmul_per_group_reference"),
    ("per_row", "planar", 128, None, False, "int4_matmul_reference"),
    ("per_group", "planar_groups", 128, None, False, "int4_matmul_per_group_reference"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("granularity,layout,gs,block_k,use_kernel,ran", GOLDEN_FORMATS)
def test_quantized_linear_golden_formats_match_jax(rng, granularity, layout, gs, block_k,
                                                   use_kernel, ran, dtype):
    """Formats no kernel takes, and ``use_kernel=False``, run the golden path
    as JAX's QuantizedLinear does, bias included."""
    w = rng.standard_normal((40, 256)).astype(np.float32) * 256 ** -0.5
    b = rng.standard_normal((40,)).astype(np.float32)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    ref_qt = jq.quantize(jnp.asarray(w), granularity=granularity, layout=layout, group_size=gs,
                         block_k=block_k)
    jlin = JaxQuantizedLinear(weight=ref_qt, bias=jnp.asarray(b), use_kernel=use_kernel)
    lin = QuantizedLinear(_port_qt(ref_qt), torch.from_numpy(b), use_kernel=use_kernel)
    before = _calls()
    y = lin(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert _ran(before) == [ran]
    assert y.dtype == getattr(torch, dtype) and y.shape == (2, 3, 40)
    _assert_close(y, jlin(jnp.asarray(x, getattr(jnp, dtype))), A16_TOL[dtype])


@pytest.mark.parametrize("rows,ran", [(4, ["int4_matmul_reference"]),
                                      (256, ["int4_linear_transient"])])
def test_per_tensor_int8_auto_dispatch_matches_jax(rng, rows, ran):
    """Under ``as_u4_turbo`` a per_tensor planar linear takes the transient
    integer GEMM at 256 rows and above, and the golden path below (no w4a8
    kernel takes per_tensor scales), as in JAX."""
    w = rng.standard_normal((48, 128)).astype(np.float32) * 128 ** -0.5
    x = rng.standard_normal((rows, 128)).astype(np.float32)
    ref_qt = jq.quantize(jnp.asarray(w), granularity="per_tensor")
    jlin = JaxQuantizedLinear(weight=ref_qt).as_u4_turbo()
    lin = QuantizedLinear(_port_qt(ref_qt)).as_u4_turbo()
    before = _calls()
    y = lin(torch.from_numpy(x))
    assert _ran(before) == ran
    _assert_close(y, jlin(jnp.asarray(x)),
                  (A8_TOL if rows >= 256 else A16_TOL)["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_tensor_transient_grouped_product_matches_jax(rng, dtype):
    """The capacity-layout transient product over per_tensor stacks: one
    scale per expert, folded after the exact integer dot as in JAX."""
    from fused4bit_tpu.ops.int8_xla import int4_grouped_transient as jax_transient

    w = rng.standard_normal((3, 40, 128)).astype(np.float32) * 128 ** -0.5
    xe = rng.standard_normal((3, 32, 128)).astype(np.float32)
    ref_qt = jq.quantize(jnp.asarray(w), granularity="per_tensor")
    y = ops.int4_grouped_transient(torch.from_numpy(xe).to(getattr(torch, dtype)),
                                   _port_qt(ref_qt))
    _assert_close(y, jax_transient(jnp.asarray(xe, getattr(jnp, dtype)), ref_qt), A8_TOL[dtype])


@pytest.mark.parametrize("granularity,layout", [("per_tensor", "planar"),
                                                ("per_row", "interleaved"),
                                                ("per_row", "block_planar")])
def test_moe_int4_golden_formats_match_jax(rng, granularity, layout):
    """Expert stacks no grouped kernel takes run the golden per-expert
    dequantize-and-matmul, through K2's counted plain version. (JAX's
    MoEINT4 hands per_row stacks of the other layouts to its grouped
    kernel, which refuses them: its golden path, ``use_kernel=False``, is
    the reference.)"""
    t, e, k, tile_m = 12, 4, 2, 8
    r = topk_route(torch.from_numpy(rng.standard_normal((t, e)).astype(np.float32)), k, e)
    p = make_dispatch_plan(r, e, tile_m=tile_m)
    xs = dispatch(torch.from_numpy(rng.standard_normal((t, 128)).astype(np.float32)), r, p)
    w = rng.standard_normal((e, 96, 128)).astype(np.float32) * 128 ** -0.5
    ref_qt = jq.quantize(jnp.asarray(w), granularity=granularity, layout=layout)
    ex = MoEINT4(_port_qt(ref_qt))
    before = _calls()
    y = ex(xs, p.tile_group_ids, tile_m=tile_m)
    assert _ran(before) == ["grouped_int4_matmul_reference"]
    want = jax_moe.MoEINT4(weight=ref_qt, use_kernel=granularity == "per_tensor")(
        jnp.asarray(xs.numpy()), jnp.asarray(p.tile_group_ids.numpy()))
    _assert_close(y, want, A16_TOL["float32"])


def _per_tensor_block(rng, e=4, h=128, ffn=256, k=2):
    """A JAX MoEBlock with a per-row router and per_tensor experts, and the
    port's block on the same bytes."""
    def dense(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * shape[-1] ** -0.5)

    jrouter = JaxQuantizedLinear.from_dense(dense(e, h))
    jexperts = [jax_moe.MoEINT4.from_dense(dense(e, n, kk), granularity="per_tensor")
                for n, kk in ((ffn, h), (ffn, h), (h, ffn))]
    jblk = jax_transformer.MoEBlock(router=jrouter, w_gate=jexperts[0], w_up=jexperts[1],
                                    w_down=jexperts[2], num_experts=e, top_k=k,
                                    prefill_threshold=4, prefill_tile_m=64)
    blk = MoEBlock(QuantizedLinear(_port_qt(jrouter.weight)),
                   *(MoEINT4(_port_qt(m.weight)) for m in jexperts), num_experts=e, top_k=k,
                   prefill_threshold=4, prefill_tile_m=64)
    return jblk, blk


# 10 tokens past the threshold of 4: u4_turbo's capacity layout on transient
# i8 weights (JAX's transient_ok admits per_tensor); 3 tokens: the dropless
# grouped path, golden for per_tensor experts (the per-row router: K1's plain
# version, or under u4_turbo K5's, which this test does not count)
@pytest.mark.parametrize("mode,t,ran", [
    ("kernel", 3, ["grouped_int4_matmul_reference", "int4_matmul_reference"]),
    ("u4_turbo", 3, ["grouped_int4_matmul_reference"]),
    ("u4_turbo", 10, ["int4_grouped_transient"]),
])
def test_moe_block_per_tensor_experts_match_jax(rng, mode, t, ran):
    jblk, blk = _per_tensor_block(rng)
    if mode == "u4_turbo":
        jblk, blk = _jax_mode(jblk, mode), _port_mode(blk, mode)
    x = rng.standard_normal((1, t, 128)).astype(np.float32)
    before = _calls()
    y = blk(torch.from_numpy(x))
    assert _ran(before) == ran
    _assert_close(y, jblk(jnp.asarray(x)), A8_TOL["float32"] if t > 4 else A16_TOL["float32"])


@pytest.mark.parametrize("granularity", ["per_row", "per_tensor"])
def test_quantized_moe_matches_jax(rng, granularity):
    """The dequantize-then-matmul MoE module on the same routing, and its
    memory accounting."""
    t, e, k = 7, 4, 2
    w = rng.standard_normal((e, 64, 128)).astype(np.float32) * 128 ** -0.5
    x = rng.standard_normal((t, 128)).astype(np.float32)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    jm = jax_moe.QuantizedMoE.from_dense(jnp.asarray(w), granularity=granularity)
    m = QuantizedMoE.from_dense(torch.from_numpy(w), granularity=granularity)
    for field in ("packed", "scales", "zero_points"):
        np.testing.assert_array_equal(getattr(m.weight, field).numpy(),
                                      np.asarray(getattr(jm.weight, field)))
    y = m(torch.from_numpy(x), topk_route(torch.from_numpy(logits), k, e))
    want = jm(jnp.asarray(x), jax_moe.topk_route(jnp.asarray(logits), k, e))
    _assert_close(y, want, A16_TOL["float32"])
    assert m.total_memory_bytes() == jm.total_memory_bytes()


def test_per_tensor_conversion_matches_jax():
    """``convert_checkpoint(granularity="per_tensor")``: every leaf equals
    JAX's conversion byte for byte (read with ``model_from_jax``), and the
    logits match JAX's over a prefill and three decode steps."""
    jcfg, cfg = _configs(H256)
    params = _random_checkpoint(cfg, seed=4)
    model = convert_checkpoint(params, cfg, device="cpu", granularity="per_tensor")
    jmodel = jax_convert_checkpoint(params, jcfg, granularity="per_tensor")
    _assert_same_module(model, model_from_jax(_params(jmodel), cfg, device="cpu"))
    assert model.blocks[1].moe.w_down.granularity == "per_tensor"
    _prefill_and_decode_match(jmodel, model, cfg)


@pytest.mark.parametrize("granularity,layout", [("per_tensor", "interleaved"),
                                                ("per_row", "block_planar"),
                                                ("per_row", "interleaved")])
def test_model_from_jax_reads_every_format(granularity, layout):
    """A JAX model whose weights are all requantized to another format: the
    port reads its leaves byte for byte (the layout named, as JAX keeps it
    static), and its forward, on the golden path, equals that of the same
    codes read planar with ``use_kernel=False``."""
    cfg = flagship_model_config("tiny")
    jmodel = jax_transformer.QuantizedTransformer.init(jax.random.PRNGKey(0), jax_flagship("tiny"))

    def requant(m, layout):
        if not hasattr(m, "weight") or not isinstance(m.weight, jq.QuantizedTensor):
            return m
        return dataclasses.replace(m, weight=jq.quantize(
            jq.dequantize(m.weight), granularity=granularity, layout=layout))

    def convert(layout):
        return jax.tree_util.tree_map(lambda m: requant(m, layout), jmodel,
                                      is_leaf=lambda m: hasattr(m, "weight"))

    model = model_from_jax(_params(convert(layout)), cfg, device="cpu", layout=layout)
    planar = model_from_jax(_params(convert("planar")), cfg, device="cpu")
    jtree = convert(layout)
    jw, w = jtree.blocks[1].moe.w_up.weight, model.blocks[1].moe.w_up.weight
    assert (w.granularity, w.layout, w.block_k) == (jw.granularity, jw.layout, jw.block_k)
    np.testing.assert_array_equal(w.packed.numpy(), np.asarray(jw.packed))
    for lin in list(planar.modules()):
        if isinstance(lin, (QuantizedLinear, MoEINT4)):
            lin.use_kernel = False
    tokens, pos = torch.tensor([[3, 1, 4, 1, 5]]), torch.arange(5)
    with torch.no_grad():
        got, _ = model(tokens, model.init_cache(cfg, 1, 8), pos)
        want, _ = planar(tokens, planar.init_cache(cfg, 1, 8), pos)
    assert torch.equal(got, want)


@pytest.mark.parametrize("granularity,activation,rows", [
    ("per_row", "bf16", 4), ("per_row", "int8", 4), ("per_row", "int8_auto", 256),
    ("per_group", "bf16", 4)])
def test_padded_for_kernel_pads_to_the_shared_multiple(rng, granularity, activation, rows):
    """``padded_for_kernel`` pads the rows once to the integer GEMM's
    multiple, the padded rows dequantize to zeros, and the outputs, sliced
    back to ``out_features``, are unchanged."""
    w = torch.from_numpy(rng.standard_normal((45, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((45,)).astype(np.float32))
    lin = QuantizedLinear.from_dense(w, b, granularity=granularity, group_size=64,
                                     activation=activation)
    padded = lin.padded_for_kernel()
    assert padded.shape[-2] == 48 and 48 % ROW_MULTIPLE == 0 and padded.out_dim == 45
    assert torch.all(dequantize(padded.weight)[45:] == 0)
    assert padded.padded_for_kernel() is padded
    x = torch.from_numpy(rng.standard_normal((rows, 128)).astype(np.float32))
    torch.testing.assert_close(padded(x), lin(x))
    per_tensor = QuantizedLinear(quantize(w, granularity="per_tensor"))
    assert per_tensor.padded_for_kernel() is per_tensor


def test_nbytes_equal_jax(rng):
    """``nbytes`` of the linears and of the whole model (every tensor it
    holds, the i8-resident copies included) equal the JAX package's."""
    w = rng.standard_normal((40, 256)).astype(np.float32)
    b = rng.standard_normal((40,)).astype(np.float32)
    for kw in (dict(), dict(granularity="per_group", group_size=64)):
        jlin = JaxQuantizedLinear.from_dense(jnp.asarray(w), jnp.asarray(b), **kw)
        lin = QuantizedLinear.from_dense(torch.from_numpy(w), torch.from_numpy(b), **kw)
        assert lin.nbytes == jlin.nbytes
    dense = DenseLinear(torch.from_numpy(w).bfloat16())
    assert dense.nbytes == JaxDenseLinear(weight=jnp.asarray(w, jnp.bfloat16)).nbytes
    cfg = flagship_model_config("tiny")
    jmodel = jax_transformer.QuantizedTransformer.init(jax.random.PRNGKey(0), jax_flagship("tiny"))
    model = model_from_jax(_params(jmodel), cfg, device="cpu")
    assert model.nbytes == jmodel.nbytes
    assert as_xla_turbo(model).nbytes == jax_transformer.as_xla_turbo(jmodel).nbytes


def test_simulate_router_logits_follows_jax_laws():
    """The three laws of JAX's simulator: the shape, the scale of each law
    and the skewed law's bias row log(1/(i+1)), both packages' draws held
    to the law (the bits of ``jax.random`` are not reproduced)."""
    t, e = 20000, 8
    bias = np.log(1.0 / (np.arange(e) + 1.0))
    gen = torch.Generator().manual_seed(0)
    for dist, std in (("uniform", 0.01), ("random", 10.0)):
        logits = simulate_router_logits(gen, t, e, dist)
        assert logits.shape == (t, e) and logits.dtype == torch.float32
        assert abs(float(logits.std()) / std - 1) < 0.05, dist
    got = simulate_router_logits(gen, t, e, "skewed").numpy()
    want = np.asarray(jax_moe.simulate_router_logits(jax.random.PRNGKey(0), t, e, "skewed"))
    for logits in (got, want):
        np.testing.assert_allclose(logits.mean(axis=0), bias, atol=0.05)
        np.testing.assert_allclose(logits.std(axis=0), 1.0, atol=0.05)
    with pytest.raises(ValueError):
        simulate_router_logits(gen, t, e, "zipf")


def test_quantized_linear_alias(rng):
    qt = quantize(torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32)))
    x = torch.randn(3, 64)
    assert torch.equal(ops.quantized_linear(x, qt), ops.int4_matmul(x, qt))
