"""Port vs JAX package: the dense twin (``models/dense_baseline.py``).

``dense_from_quantized`` on the same INT4 bytes (the ``tiny`` model carried
over with ``model_from_jax``) and ``dense_from_params`` on the same
checkpoint dict, against JAX's ``DenseTransformer``, in both MoE
implementations; and the port's copy of JAX's plumbing regression test
(``tests/test_model.py::test_moe_impl_is_plumbed_and_equivalent``).

Tolerances: in f32 both sides compute the same dense products in another
order: logits within 1e-4 of the largest. In bf16 (the twin's default) each
matmul rounds to bf16: within 2e-2 of the largest, the bf16 ladder of the
other model tests. The two MoE implementations against each other: JAX's
rtol = atol = 2e-4 in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.models.config import flagship_model_config
from fused4bit_tpu.models.dense_baseline import dense_from_quantized as jax_dense_from_quantized
from fused4bit_tpu.models.transformer import QuantizedTransformer as JaxTransformer
from fused4bit_tpu.quant.equalize import _dense_from_params as jax_dense_from_params
from fused4bit_tpu_torch.models import (
    DenseKVCache,
    DenseTransformer,
    dense_from_params,
    dense_from_quantized,
    model_from_jax,
)
from test_torch_convert import _random_checkpoint
from test_torch_model import _params

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: several test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = flagship_model_config("tiny")
    jmodel = JaxTransformer.init(jax.random.PRNGKey(0), cfg)
    return cfg, jmodel, model_from_jax(_params(jmodel), cfg, device="cpu")


def _run_both(jdense, dense, cfg, dtype, steps=3):
    """A 5-token prefill then ``steps`` decode steps fed JAX's greedy token:
    the logits of both twins at every step, as f32 numpy arrays."""
    b, t, max_seq = 2, 5, 16
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, t), dtype=np.int32)
    jcaches = jdense.init_cache(cfg, b, max_seq, dtype=getattr(jnp, dtype))
    caches = dense.init_cache(cfg, b, max_seq, dtype=_TORCH[dtype])
    positions = np.arange(t, dtype=np.int32)
    out = []
    with torch.no_grad():
        for _ in range(steps + 1):
            jl, jcaches = jdense(jnp.asarray(tokens), jcaches, jnp.asarray(positions))
            pl, caches = dense(torch.from_numpy(tokens).long(), caches,
                               torch.from_numpy(positions).long())
            ref = np.asarray(jl.astype(jnp.float32))
            out.append((pl.float().numpy(), ref))
            tokens = ref[:, -1].argmax(-1).astype(np.int32)[:, None]
            positions = positions[-1:] + 1
    for c, jc in zip(caches, jcaches):
        np.testing.assert_array_equal(c.lengths.numpy(), np.asarray(jc.lengths))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moe_impl", ["gather", "dense_all"])
def test_dense_from_quantized_matches_jax(tiny, moe_impl, dtype):
    cfg, jmodel, model = tiny
    jdense = jax_dense_from_quantized(jmodel, dtype=getattr(jnp, dtype), moe_impl=moe_impl)
    dense = dense_from_quantized(model, dtype=_TORCH[dtype], moe_impl=moe_impl)
    assert isinstance(dense, DenseTransformer)
    np.testing.assert_array_equal(dense.blocks[1].w_down.float().numpy(),
                                  np.asarray(jdense.blocks[1].w_down.astype(jnp.float32)))
    for got, ref in _run_both(jdense, dense, cfg, dtype):
        assert got.shape == ref.shape
        assert np.max(np.abs(got - ref)) <= TOL[dtype] * np.max(np.abs(ref))


def test_dense_from_params_matches_jax():
    """The f32 twin straight from a checkpoint dict, against the JAX
    package's (``quant/equalize._dense_from_params``)."""
    cfg = flagship_model_config("tiny")
    params = _random_checkpoint(cfg, seed=2)
    jdense = jax_dense_from_params(params, cfg)
    dense = dense_from_params(params, cfg, dtype=torch.float32, device="cpu")
    assert dense.blocks[0].w_gate.shape == (cfg.moe.num_experts, cfg.moe.ffn_dim,
                                            cfg.num_heads * cfg.head_dim)
    for got, ref in _run_both(jdense, dense, cfg, "float32", steps=1):
        assert np.max(np.abs(got - ref)) <= TOL["float32"] * np.max(np.abs(ref))


def test_moe_impl_is_plumbed_and_equivalent(tiny):
    """dense_from_quantized(moe_impl=...) must reach the blocks (the JAX
    package once dropped the argument, so every strong-baseline measurement
    ran the naive gather), and the two implementations compute the same
    function."""
    cfg, _, model = tiny
    strong = dense_from_quantized(model, dtype=torch.float32, moe_impl="dense_all")
    naive = dense_from_quantized(model, dtype=torch.float32)
    assert all(b.moe_impl == "dense_all" for b in strong.blocks)
    assert all(b.moe_impl == "gather" for b in naive.blocks)
    b, t = 2, 4
    toks = torch.arange(b * t).reshape(b, t) % cfg.vocab_size
    with torch.no_grad():
        ls, _ = strong(toks, strong.init_cache(cfg, b, 8, dtype=torch.float32), torch.arange(t))
        ln, _ = naive(toks, naive.init_cache(cfg, b, 8, dtype=torch.float32), torch.arange(t))
    torch.testing.assert_close(ls, ln, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="moe_impl"):
        dense_from_quantized(model, moe_impl="einsum")


def test_dense_kv_cache_appends_in_place(rng):
    cache = DenseKVCache.init(2, 2, 8, 4, dtype=torch.float32, device="cpu")
    k = torch.from_numpy(rng.standard_normal((2, 2, 3, 4)).astype(np.float32))
    v = -k
    assert cache.append(k, v, start=torch.tensor([0, 4], dtype=torch.int32)) is cache
    assert cache.lengths.tolist() == [3, 7]
    assert torch.equal(cache.k[0, :, :3], k[0]) and torch.equal(cache.v[1, :, 4:7], v[1])
    assert cache.k[0, :, 3:].abs().sum() == 0 and cache.k[1, :, :4].abs().sum() == 0
    cache.append(k[:, :, :1], v[:, :, :1])          # at each row's length
    assert cache.lengths.tolist() == [4, 8] and torch.equal(cache.k[1, :, 7], k[1, :, 0])
    assert cache.nbytes == 2 * 2 * 2 * 8 * 4 * 4
