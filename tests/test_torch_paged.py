"""Port vs JAX package: the paged INT4 KV cache, the paged attention over it
(kernel K3''s plain version on the CPU) and the `tiny` model on paged
caches, on the same numpy-seeded inputs. The JAX attention runs in
interpret mode, as tests/test_paged.py runs it on the CPU; page 16 as there
(the card's kernel needs a multiple of 32, the plain version any even page)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.layers.paged_kv import PagedKVCache as JaxPagedKVCache
from fused4bit_tpu.ops.decode_attention import paged_int4_decode_attention as jax_paged_decode
from fused4bit_tpu.ops.decode_attention import paged_int4_prefill_attention as jax_paged_prefill
from fused4bit_tpu_torch.layers import PagedKVCache, QuantizedKVCache
from fused4bit_tpu_torch.models import flagship_model_config, kv_cache_from_jax, model_from_jax
from fused4bit_tpu_torch.models.transformer import Attention
from fused4bit_tpu_torch.ops import (
    int4_decode_attention,
    int4_prefill_attention,
    paged_int4_attention_reference,
)

B, HKV, HQ, D = 2, 2, 4, 128
PAGE, MAX_PAGES, NUM_PAGES = 16, 4, 16
S = PAGE * MAX_PAGES
TABLES = {0: [5, 9, 2, 11], 1: [7, 1, 14, 3]}   # shuffled, non-identity
# f32: the same arithmetic in another order, ~1e-6 measured. bf16: q and the
# rounded ps in bf16 on both sides, the kernel's running max against the
# plain version's row max: K3's bar (chip_smoke.ATTN_ABS_TOL), one bf16 ulp
# (3.9e-3) measured.
F32_TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The `tiny` model's ops are too small to split across threads, and with
    several test workers on one machine torch's thread pool only contends
    (tens of times slower); one thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in leaves}


def _assert_same(cache, jcache):
    for f in PagedKVCache._FIELDS:
        np.testing.assert_array_equal(getattr(cache, f).numpy(), np.asarray(getattr(jcache, f)),
                                      err_msg=f)


def _caches():
    jp = JaxPagedKVCache.init(B, HKV, D, num_pages=NUM_PAGES, page_size=PAGE,
                              max_pages_per_slot=MAX_PAGES)
    p = PagedKVCache.init(B, HKV, D, num_pages=NUM_PAGES, page_size=PAGE,
                          max_pages_per_slot=MAX_PAGES, device="cpu")
    for slot, pages in TABLES.items():
        jp = jp.assign_pages(slot, pages)
        p.assign_pages(slot, pages)
    return p, jp


def _append(p, jp, c, k, v, start):
    """The same append on the port's paged cache, JAX's paged cache and, if
    given, the port's contiguous cache ``c``."""
    # a copy: ``start`` may view the port's lengths, which its append
    # rewrites while JAX's asynchronous dispatch may still read ``st``
    st = np.full((B,), start, np.int32) if np.isscalar(start) else np.array(start, np.int32)
    jp = jp.append(jnp.asarray(k), jnp.asarray(v), start=jnp.asarray(st))
    kt, vt = torch.from_numpy(np.ascontiguousarray(k)), torch.from_numpy(np.ascontiguousarray(v))
    p.append(kt, vt, start=torch.from_numpy(st))
    if c is not None:
        c.append(kt, vt, start=torch.from_numpy(st))
    return jp


def _filled(rng, t0, with_contiguous=False):
    """t0 positions in page-aligned chunks (the engine's contract), the same
    content in a contiguous cache too if asked."""
    p, jp = _caches()
    c = QuantizedKVCache.init(B, HKV, S, D, device="cpu") if with_contiguous else None
    k = rng.standard_normal((B, HKV, t0, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, t0, D)).astype(np.float32)
    for c0 in range(0, t0, PAGE):
        jp = _append(p, jp, c, k[:, :, c0:c0 + PAGE], v[:, :, c0:c0 + PAGE], c0)
    return p, jp, c


@pytest.mark.parametrize("t0", [24, 15])
def test_paged_append_bytes_equal_jax(rng, t0):
    """Chunked appends, then single steps from an even (24) or odd (15)
    length across a page boundary: pools, planes, table and lengths equal
    JAX's byte for byte."""
    p, jp, _ = _filled(rng, t0)
    _assert_same(p, jp)
    for _ in range(PAGE // 2 + 3):
        jp = _append(p, jp, None, rng.standard_normal((B, HKV, 1, D)).astype(np.float32),
                     rng.standard_normal((B, HKV, 1, D)).astype(np.float32),
                     p.lengths.numpy())
    assert p.lengths.tolist() == [t0 + PAGE // 2 + 3] * B
    _assert_same(p, jp)


def test_kv_cache_from_jax_paged_round_trips(rng):
    _, jp, _ = _filled(rng, 20)
    p = kv_cache_from_jax(_params(jp), device="cpu")
    assert isinstance(p, PagedKVCache)
    _assert_same(p, jp)
    jc = jax.tree_util.tree_map(np.asarray, (jp, jp))  # a tuple of layers: "[1]" prefix
    assert isinstance(kv_cache_from_jax(_params(jc), "[1]", device="cpu"), PagedKVCache)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_paged_attention_matches_jax(rng, kind, dtype):
    """The plain version of K3' against JAX's paged kernel on the same
    bytes, and bit for bit against the contiguous plain version on the same
    content (odd prefill starts, a chunk from mid-page)."""
    p, jp, c = _filled(rng, 24, with_contiguous=True)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if kind == "decode":
        q = rng.standard_normal((B, HQ, D)).astype(np.float32)
        ref = jax_paged_decode(jnp.asarray(q).astype(jdt), jp, compute_dtype=jdt)
        out = int4_decode_attention(torch.from_numpy(q).to(tdt), p)
        cont = int4_decode_attention(torch.from_numpy(q).to(tdt), c)
    else:
        t = 8
        q = rng.standard_normal((B, HQ, t, D)).astype(np.float32)
        starts = np.asarray([24 - t, 24 - t - 3], np.int32)
        ref = jax_paged_prefill(jnp.asarray(q).astype(jdt), jp, jnp.asarray(starts),
                                compute_dtype=jdt)
        out = int4_prefill_attention(torch.from_numpy(q).to(tdt), p, torch.from_numpy(starts))
        cont = int4_prefill_attention(torch.from_numpy(q).to(tdt), c, torch.from_numpy(starts))
    assert out.dtype == tdt and out.shape == tuple(ref.shape)
    err = np.max(np.abs(out.float().numpy() - np.asarray(ref.astype(jnp.float32))))
    assert err <= tol, err
    assert torch.equal(out, cont)


def test_paged_dispatch_counts_the_plain_version(rng):
    p, _, _ = _filled(rng, 8)
    before = paged_int4_attention_reference.calls
    int4_decode_attention(torch.zeros((B, HQ, D)), p)
    assert paged_int4_attention_reference.calls == before + 1


def test_geometry_nbytes_and_slot_views(rng):
    p, jp, _ = _filled(rng, 20)
    assert (p.page_size, p.num_pages, p.max_pages_per_slot, p.max_seq, p.head_dim) == (
        jp.page_size, jp.num_pages, jp.max_pages_per_slot, jp.max_seq, jp.head_dim)
    assert p.nbytes == jp.nbytes == NUM_PAGES * HKV * (2 * (PAGE // 2) * D + 4 * PAGE * 4)
    with pytest.raises(ValueError, match="table width"):
        p.assign_pages(0, list(range(1, MAX_PAGES + 2)))
    # slice_slot shares the pools and views the rows: an append lands in p
    part = p.slice_slot(1)
    assert part.k_pool is p.k_pool and part.lengths.data_ptr() == p.lengths[1:].data_ptr()
    pool_before = p.k_pool.clone()
    part.append(torch.randn(1, HKV, 2, D), torch.randn(1, HKV, 2, D))
    assert p.lengths.tolist() == [20, 22]
    changed = (p.k_pool != pool_before).flatten(1).any(dim=1).nonzero().flatten().tolist()
    assert changed == [TABLES[1][1]]              # position 20 lies in the slot's 2nd page
    # merging its own view back copies nothing
    copies = []
    orig = torch.Tensor.copy_
    torch.Tensor.copy_ = lambda self, src, *a, **k: copies.append(1) or orig(self, src, *a, **k)
    try:
        p.merge_slot(part, 1)
    finally:
        torch.Tensor.copy_ = orig
    assert copies == []
    p.reset_slot(1)
    assert p.lengths.tolist() == [20, 0] and p.page_table[1].tolist() == [0] * MAX_PAGES


def test_parked_rows_never_reach_live_pages(rng):
    """Several parked rows (tables at page 0) write their junk in the same
    step as a live row: page 0 takes it, in any order, and so does a write
    whose page lies past the table; no live page moves but the one the live
    row writes."""
    b = 4
    p = PagedKVCache.init(b, HKV, D, num_pages=8, page_size=PAGE, max_pages_per_slot=2,
                          device="cpu")
    p.assign_pages(0, [3, 5])
    p.lengths[1:] = torch.tensor([7, 16, 31], dtype=torch.int32)  # stale parked positions
    # the live row writes page 3, then lies past its table (page 0 only)
    for live_start, may_move in ((0, {0, 3}), (2 * PAGE, {0})):
        p.lengths[0] = live_start
        before = [t.clone() for t in (p.k_pool, p.v_pool, p.k_scale, p.v_zp)]
        for _ in range(3):
            p.append(torch.randn(b, HKV, 1, D), torch.randn(b, HKV, 1, D))
        for old, new in zip(before, (p.k_pool, p.v_pool, p.k_scale, p.v_zp)):
            moved = (old != new).flatten(1).any(dim=1).nonzero().flatten().tolist()
            assert set(moved) <= may_move, moved


def test_contiguous_cache_nbytes_and_length():
    from fused4bit_tpu.layers.kv_cache import QuantizedKVCache as JaxKVCache

    c = QuantizedKVCache.init(3, HKV, S, D, device="cpu")
    assert c.nbytes == JaxKVCache.init(3, HKV, S, D).nbytes == 3 * HKV * (S * D + 4 * S * 4)
    c.lengths.copy_(torch.tensor([4, 9, 2], dtype=torch.int32))
    assert int(c.length) == 9


def test_attention_golden_path_on_paged_cache(rng):
    """The model's golden path (dequantize, dense attention) reads the
    paged cache's logical view and agrees with the fused path over it."""
    cfg = flagship_model_config("tiny")
    fused = Attention.init(cfg, cfg.num_heads * cfg.head_dim,
                           generator=torch.Generator().manual_seed(0), device="cpu")
    golden = Attention(fused.wq, fused.wk, fused.wv, fused.wo, num_heads=cfg.num_heads,
                       num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                       rope_theta=cfg.rope_theta, use_fused_attention=False)
    x = torch.from_numpy(rng.standard_normal((B, 6, cfg.num_heads * cfg.head_dim))).bfloat16()
    pos = torch.tensor([[0, 1, 2, 3, 4, 5], [10, 11, 12, 13, 14, 15]], dtype=torch.int32)
    outs = []
    for attn in (fused, golden):
        cache = PagedKVCache.init(B, cfg.num_kv_heads, cfg.head_dim, num_pages=5,
                                  page_size=PAGE, max_pages_per_slot=2, device="cpu")
        cache.assign_pages(0, [4, 1]).assign_pages(1, [2, 3])
        out, cache = attn(x, cache, pos)
        assert cache.lengths.tolist() == [6, 16]
        outs.append(out.float())
    assert torch.max(torch.abs(outs[0] - outs[1])) <= 2e-2 * torch.max(torch.abs(outs[1]))


def test_tiny_model_on_paged_caches_matches_jax():
    """The `tiny` model on paged caches against JAX's, from the same leaves:
    a prefill then one decode step fed JAX's greedy token, logits within
    2e-2 of their max, as the contiguous model test holds them."""
    from fused4bit_tpu.models.transformer import QuantizedTransformer as JaxTransformer

    cfg = flagship_model_config("tiny")
    jmodel = JaxTransformer.init(jax.random.PRNGKey(0), cfg)
    model = model_from_jax(_params(jmodel), cfg, device="cpu")
    kw = dict(num_pages=5, page_size=PAGE, max_pages_per_slot=2)
    jcaches = tuple(c.assign_pages(0, [3, 1]).assign_pages(1, [4, 2])
                    for c in jmodel.init_paged_cache(cfg, B, **kw))
    caches = tuple(c.assign_pages(0, [3, 1]).assign_pages(1, [4, 2])
                   for c in model.init_paged_cache(cfg, B, **kw))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 5), dtype=np.int32)
    positions = np.arange(5, dtype=np.int32)
    for step in range(2):
        jlogits, jcaches = jmodel(jnp.asarray(tokens), jcaches, jnp.asarray(positions))
        with torch.no_grad():
            logits, caches = model(torch.from_numpy(tokens), caches, torch.from_numpy(positions))
        ref = np.asarray(jlogits.astype(jnp.float32))
        got = logits.float().numpy()
        assert np.max(np.abs(got - ref)) <= 2e-2 * np.max(np.abs(ref)), f"step {step}"
        tokens = ref[:, -1].argmax(axis=-1).astype(np.int32)[:, None]
        positions = np.asarray([5 + step], np.int32)
    for c, jc in zip(caches, jcaches):
        np.testing.assert_array_equal(c.lengths.numpy(), np.asarray(jc.lengths))
        np.testing.assert_array_equal(c.page_table.numpy(), np.asarray(jc.page_table))
