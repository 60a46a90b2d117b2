"""Port vs JAX package: the pair-packed INT4 KV cache append and the
attention over it (kernel K3's plain version on CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.layers.kv_cache import QuantizedKVCache as JaxKVCache
from fused4bit_tpu.ops.decode_attention import int4_decode_attention as jax_decode
from fused4bit_tpu.ops.decode_attention import int4_prefill_attention as jax_prefill
from fused4bit_tpu_torch.layers import QuantizedKVCache
from fused4bit_tpu_torch.models import flagship_model_config, kv_cache_from_jax
from fused4bit_tpu_torch.models.transformer import Attention
from fused4bit_tpu_torch.ops import int4_decode_attention, int4_prefill_attention

B, HKV, S, D = 2, 2, 32, 64


def _params(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in leaves}


def _assert_same_cache(cache, jcache):
    for f in QuantizedKVCache._FIELDS:
        np.testing.assert_array_equal(getattr(cache, f).numpy(), np.asarray(getattr(jcache, f)),
                                      err_msg=f)


def _filled(rng, steps):
    """Both caches after the same appends; steps = [(starts, T), ...]."""
    jc = JaxKVCache.init(B, HKV, S, D)
    c = QuantizedKVCache.init(B, HKV, S, D, device="cpu")
    for starts, t in steps:
        k = rng.standard_normal((B, HKV, t, D)).astype(np.float32)
        v = rng.standard_normal((B, HKV, t, D)).astype(np.float32)
        st = np.asarray(starts, np.int32)
        jc = jc.append(jnp.asarray(k), jnp.asarray(v), start=jnp.asarray(st))
        c = c.append(torch.from_numpy(k), torch.from_numpy(v), start=torch.from_numpy(st))
    return c, jc


# even/odd starts per row, odd and even T, and a decode step at an odd position
@pytest.mark.parametrize("steps", [
    [([0, 0], 5)],
    [([0, 3], 7), ([7, 10], 1)],
    [([1, 2], 4), ([5, 6], 3), ([8, 9], 1)],
])
def test_kv_append_bytes_equal_jax(rng, steps):
    c, jc = _filled(rng, steps)
    _assert_same_cache(c, jc)


def test_kv_cache_converted_from_jax_is_the_same(rng):
    _, jc = _filled(rng, [([0, 1], 9)])
    _assert_same_cache(kv_cache_from_jax(_params(jc), device="cpu"), jc)


def test_slot_slice_merge_reset(rng):
    c, _ = _filled(rng, [([0, 0], 6)])
    part = c.slice_slot(1)
    part.append(torch.randn(1, HKV, 3, D), torch.randn(1, HKV, 3, D))
    assert c.lengths.tolist() == [6, 9]          # the slice is a view
    other = QuantizedKVCache.init(B, HKV, S, D, device="cpu").merge_slot(part, 0)
    assert torch.equal(other.k_packed[0], c.k_packed[1])
    assert other.lengths.tolist() == [9, 0]
    c.reset_slot(1)
    assert c.lengths.tolist() == [6, 0]


def test_attention_golden_path_matches_fused(rng):
    cfg = flagship_model_config("tiny")
    fused = Attention.init(cfg, cfg.num_heads * cfg.head_dim, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    golden = Attention(fused.wq, fused.wk, fused.wv, fused.wo, num_heads=cfg.num_heads,
                       num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                       rope_theta=cfg.rope_theta, use_fused_attention=False)
    x = torch.from_numpy(rng.standard_normal((B, 6, cfg.num_heads * cfg.head_dim))).bfloat16()
    pos = torch.tensor([[0, 1, 2, 3, 4, 5], [3, 4, 5, 6, 7, 8]], dtype=torch.int32)
    outs = []
    for attn in (fused, golden):
        cache = QuantizedKVCache.init(B, cfg.num_kv_heads, S, cfg.head_dim, device="cpu")
        cache.lengths[1] = 3   # row 1 continues a sequence at position 3
        out, cache = attn(x, cache, pos)
        assert cache.lengths.tolist() == [6, 9]
        outs.append(out.float())
    assert torch.max(torch.abs(outs[0] - outs[1])) <= 2e-2 * torch.max(torch.abs(outs[1]))


def test_decode_attention_matches_jax(rng):
    c, jc = _filled(rng, [([0, 0], 5), ([5, 5], 8), ([13, 13], 1)])
    q = rng.standard_normal((B, 4, D)).astype(np.float32)
    ref = np.asarray(jax_decode(jnp.asarray(q), jc, compute_dtype=jnp.float32))
    out = int4_decode_attention(torch.from_numpy(q), c)
    assert out.shape == (B, 4, D)
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-3


def test_prefill_attention_matches_jax(rng):
    # row 0 prefills 7 tokens from position 0; row 1 a chunk from odd position 3
    c, jc = _filled(rng, [([0, 0], 3), ([0, 3], 7)])
    q = rng.standard_normal((B, 4, 7, D)).astype(np.float32)
    starts = np.asarray([0, 3], np.int32)
    ref = np.asarray(jax_prefill(jnp.asarray(q), jc, jnp.asarray(starts),
                                 compute_dtype=jnp.float32))
    out = int4_prefill_attention(torch.from_numpy(q), c, torch.from_numpy(starts))
    assert out.shape == (B, 4, 7, D)
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-3
