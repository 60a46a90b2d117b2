"""The port's serving engine in paged mode (page allocator, admission
control, prefix caching) and with decode blocks, on the `tiny` model on the
CPU: the engine tests of tests/test_paged.py and the decode-block tests of
tests/test_serving.py, repeated on the port, and one request stream fed to
the JAX and the port's paged engines at decode_block=4 on the same weights,
whose page assignments must agree and whose tokens must be greedy under
JAX's teacher-forced forward.

On the CPU the paged plain attention equals the contiguous one bit for bit
on the same content, and a decode block runs the same model calls as single
steps, so greedy outputs are compared whole here, where the JAX tests
compare first tokens across separately compiled programs."""
import numpy as np
import pytest
import torch

from fused4bit_tpu_torch.models import (
    QuantizedTransformer,
    as_u4_turbo,
    flagship_model_config,
    model_from_jax,
)
from fused4bit_tpu_torch.serving import GenerationRequest, Sampler, ServingEngine, generate

KW = dict(num_slots=2, max_seq=64, prefill_bucket=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The `tiny` model's ops are too small to split across threads, and with
    several test workers on one machine torch's thread pool only contends
    (tens of times slower); one thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = flagship_model_config("tiny")
    return QuantizedTransformer.init(cfg, generator=torch.Generator().manual_seed(0),
                                     device="cpu"), cfg


def _run(model, cfg, reqs, **kw):
    eng = ServingEngine(model, cfg, **{**KW, **kw})
    for r in reqs:
        eng.submit(GenerationRequest(**vars(r)))
    return eng, eng.run()


def jax_params(tree):
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in leaves}


def _check_allocator(eng):
    """A page is free XOR held XOR retained; refcounts equal the number of
    slot tables holding the page; no page is handed out twice."""
    held = {}
    for slot, pages in eng._slot_pages.items():
        assert len(set(pages)) == len(pages), f"dup pages in slot {slot}"
        for p in pages:
            held[p] = held.get(p, 0) + 1
    free = set(eng._free_pages)
    assert len(free) == len(eng._free_pages), "duplicate free pages"
    assert not (free & set(held)), f"page both free and held: {free & set(held)}"
    for p in range(1, eng.num_pages):
        assert eng._page_refs[p] == held.get(p, 0), (p, eng._page_refs[p], held.get(p, 0))
        if eng._page_keys.get(p) and eng._page_refs[p] == 0:
            assert p not in free, f"retained page {p} also free"
        if eng._page_refs[p] == 0 and not eng._page_keys.get(p):
            assert p in free, f"page {p} leaked (no refs, no entry, not free)"


def test_paged_greedy_equals_contiguous(tiny):
    model, cfg = tiny
    reqs = [GenerationRequest(uid=0, prompt=[1, 2, 3], max_new_tokens=5),
            GenerationRequest(uid=1, prompt=[7, 8, 9, 4, 2], max_new_tokens=4),
            GenerationRequest(uid=2, prompt=[5], max_new_tokens=3)]
    _, out_c = _run(model, cfg, reqs)
    eng, out_p = _run(model, cfg, reqs, paged=True, page_size=16)
    assert out_p == out_c and set(out_c) == {0, 1, 2}
    assert eng.caches[0].nbytes == eng.model.init_cache(cfg, 2, 64)[0].nbytes + \
        eng.caches[0].nbytes // eng.num_pages          # 2 slots x 4 pages + page 0


def test_page_pool_oversubscription(tiny):
    """5 usable pages of 16 for 2 slots x max_seq 64: the third request
    waits at the head of the queue for a retirement, and all complete."""
    model, cfg = tiny
    eng = ServingEngine(model, cfg, **KW, paged=True, page_size=16, num_pages=6)
    for uid in range(3):
        eng.submit(GenerationRequest(uid=uid, prompt=[1 + uid, 2, 3], max_new_tokens=30))
    waited = 0
    while eng.active or eng.queue:
        eng.step()
        waited += bool(eng.queue) and len(eng.active) < eng.num_slots
        _check_allocator(eng)
    assert waited > 0
    assert set(eng.finished) == {0, 1, 2} and all(len(v) == 30 for v in eng.finished.values())
    assert sorted(eng._free_pages) == list(range(1, 6))


def test_request_too_big_for_pool(tiny):
    model, cfg = tiny
    eng = ServingEngine(model, cfg, **KW, paged=True, page_size=16, num_pages=3)
    eng.submit(GenerationRequest(uid=0, prompt=[1] * 40, max_new_tokens=8))
    with pytest.raises(ValueError, match="pages"):
        eng.run()


def test_prefix_caching_shares_pages_and_matches(tiny):
    model, cfg = tiny
    prefix = list(range(1, 17))            # exactly one 16-token page
    reqs = [GenerationRequest(uid=uid, prompt=prefix + tail, max_new_tokens=4)
            for uid, tail in enumerate([[30], [40, 41], [50]])]
    outs = {}
    for pc in (True, False):
        eng, outs[pc] = _run(model, cfg, reqs, num_slots=3, paged=True, page_size=16,
                             prefix_caching=pc)
        if pc:
            assert eng.prefix_stats["hits"] == 2, eng.prefix_stats
            assert eng.prefix_stats["shared_tokens"] == 32, eng.prefix_stats
            assert all(r == 0 for r in eng._page_refs)
            assert eng._prefix_entries
            assert len(eng._page_keys) + len(eng._free_pages) == eng.num_pages - 1
    assert outs[True] == outs[False]


def test_decode_never_writes_a_shared_prefix_page(tiny):
    """Two live slots share a prefix page; their prefills of the tails and
    their decode steps leave its bytes as the first prefill wrote them."""
    model, cfg = tiny
    prefix = list(range(2, 18))
    eng = ServingEngine(model, cfg, **KW, paged=True, page_size=16)
    eng.submit(GenerationRequest(uid=0, prompt=prefix + [1], max_new_tokens=20))
    eng.submit(GenerationRequest(uid=1, prompt=prefix + [9, 3], max_new_tokens=20))
    eng._admit()
    shared = [p for p, r in enumerate(eng._page_refs) if r == 2]
    assert len(shared) == 1 and eng.prefix_stats["hits"] == 1
    snap = [(c.k_pool[shared[0]].clone(), c.v_zp[shared[0]].clone()) for c in eng.caches]
    eng.run()
    for c, (kp, vz) in zip(eng.caches, snap):
        assert torch.equal(c.k_pool[shared[0]], kp) and torch.equal(c.v_zp[shared[0]], vz)


def test_prefix_pages_refcounted_across_retirement(tiny):
    model, cfg = tiny
    eng = ServingEngine(model, cfg, **KW, paged=True, page_size=16)
    prefix = list(range(2, 18))
    eng.submit(GenerationRequest(uid=0, prompt=prefix + [1], max_new_tokens=12))
    eng.submit(GenerationRequest(uid=1, prompt=prefix + [9], max_new_tokens=2))
    eng._admit()
    assert eng.prefix_stats["hits"] == 1
    shared = [p for p, r in enumerate(eng._page_refs) if r == 2]
    assert len(shared) == 1
    while 1 in {r.uid for r in eng.active.values()}:
        eng.step()
    assert eng._page_refs[shared[0]] == 1 and eng._prefix_entries
    eng.run()
    assert eng._page_refs[shared[0]] == 0 and eng._prefix_entries
    assert shared[0] not in eng._free_pages
    eng._evict_prefix_entries(len(eng._free_pages) + 1)
    assert eng._prefix_entries == {}
    assert shared[0] in eng._free_pages
    assert eng.prefix_stats["evictions"] >= 1


def test_prefix_retention_hits_sequential_requests(tiny):
    model, cfg = tiny
    sys_prompt = list(range(3, 19))
    eng = ServingEngine(model, cfg, num_slots=1, max_seq=64, prefill_bucket=8, paged=True,
                        page_size=16, num_pages=5)
    outs = {}
    for uid in range(3):
        eng.submit(GenerationRequest(uid=uid, prompt=sys_prompt + [40 + uid], max_new_tokens=3))
        outs.update(eng.run())
    assert eng.prefix_stats["hits"] == 2 and eng.prefix_stats["shared_tokens"] == 32
    assert len(outs) == 3 and all(len(v) == 3 for v in outs.values())
    assert all(r == 0 for r in eng._page_refs)


def test_eviction_never_reclaims_matched_prefix(tiny):
    model, cfg = tiny
    mk = lambda pc: ServingEngine(model, cfg, **KW, paged=True, page_size=16,  # noqa: E731
                                  num_pages=6, prefix_caching=pc)
    eng = mk(True)
    prefix32 = list(range(1, 33))          # two full pages
    eng.submit(GenerationRequest(uid=0, prompt=prefix32 + [40], max_new_tokens=2))
    while eng.active or eng.queue:
        eng.step()
        _check_allocator(eng)
    eng.submit(GenerationRequest(uid=1, prompt=[50 + i for i in range(17)], max_new_tokens=12))
    eng._admit()
    _check_allocator(eng)
    eng.submit(GenerationRequest(uid=2, prompt=prefix32 + [41], max_new_tokens=8))
    while eng.active or eng.queue:
        eng.step()
        _check_allocator(eng)
    assert set(eng.finished) == {0, 1, 2}
    eng0 = mk(False)
    eng0.submit(GenerationRequest(uid=2, prompt=prefix32 + [41], max_new_tokens=8))
    assert eng.finished[2] == eng0.run()[2]


def test_paged_decode_block_crosses_page_boundary(tiny):
    model, cfg = tiny
    prompt = list(range(1, 15))  # 14 tokens; page 16: decode crosses at 16 mid-block
    outs = {}
    for name, kw in (("blk4", dict(paged=True, page_size=16, decode_block=4)),
                     ("blk1", dict(paged=True, page_size=16)), ("cont", {})):
        _, out = _run(model, cfg, [GenerationRequest(uid=0, prompt=prompt, max_new_tokens=8)], **kw)
        outs[name] = out[0]
    assert len(outs["blk4"]) == 8
    assert outs["blk4"] == outs["blk1"] == outs["cont"]


@pytest.mark.parametrize("kw, match", [
    (dict(prefill_bucket=12, paged=True, page_size=16, max_seq=48), "multiple of prefill_bucket"),
    (dict(max_seq=72, paged=True, page_size=16), "multiple of page_size"),
    (dict(paged=True, page_size=16, mesh=object()), "single-chip"),
    (dict(max_seq=60), "multiple of prefill_bucket"),
    (dict(decode_block=0), "decode_block"),
])
def test_invalid_engine_config(tiny, kw, match):
    model, cfg = tiny
    with pytest.raises(ValueError, match=match):
        ServingEngine(model, cfg, **{**KW, **kw})


TIE_BAND = 0.2  # bf16 logits: a handful of ulps at |logit| ~ 4 (tests/test_speculative.py)


def assert_greedy_under_jax(jmodel, jcfg, prompts, outs):
    """Every generated token is the argmax of one fresh teacher-forced JAX
    forward over prompt + output, or the runner-up inside the near-tie band
    (the two packages round bf16 logits apart, so greedy chains may part at
    a near tie). The sequences run as one right-padded batch, whose causal
    mask keeps the padding out of every real position, and eagerly, as in
    tests/test_speculative.py: under jit, XLA's fusions round otherwise and
    can flip a near-tied MoE routing."""
    import jax.numpy as jnp

    seqs = [list(p) + list(o) for p, o in zip(prompts, outs)]
    length = max(len(s) for s in seqs)
    tokens = np.zeros((len(seqs), length), np.int32)
    for i, s in enumerate(seqs):
        tokens[i, :len(s)] = s
    positions = jnp.broadcast_to(jnp.arange(length, dtype=jnp.int32), tokens.shape)
    logits, _ = jmodel(jnp.asarray(tokens), jmodel.init_cache(jcfg, len(seqs), length + length % 2),
                       positions)
    logits = np.asarray(logits.astype(jnp.float32))
    for i, (prompt, out) in enumerate(zip(prompts, outs)):
        for j, tok in enumerate(out):
            row = logits[i, len(prompt) - 1 + j]
            top2 = np.argsort(row)[-2:][::-1]
            gap = float(row[top2[0]] - row[top2[1]])
            assert tok == top2[0] or (tok == top2[1] and gap < TIE_BAND), (
                f"sequence {i} token {j}: {tok} is not greedy (top2={top2.tolist()} gap={gap})")


def test_jax_and_port_paged_engines_assign_the_same_pages():
    """One request stream (shared prefixes, a pool too small for both slots
    at once, retention and eviction) through JAX's paged engine and the
    port's, both at decode_block=4 on the same `tiny` weights (the port's
    from JAX's leaves): after every step the same page list per slot, the
    same free list, refcounts and prefix entries; at the end the same
    prefix_stats and token counts, and every token of the port greedy under
    JAX's teacher-forced forward."""
    import jax

    from fused4bit_tpu.models.config import flagship_model_config as jax_config
    from fused4bit_tpu.models.transformer import QuantizedTransformer as JaxTransformer
    from fused4bit_tpu.serving.engine import GenerationRequest as JaxRequest
    from fused4bit_tpu.serving.engine import ServingEngine as JaxEngine

    jcfg, cfg = jax_config("tiny"), flagship_model_config("tiny")
    jmodel = JaxTransformer.init(jax.random.PRNGKey(0), jcfg)
    model = model_from_jax(jax_params(jmodel), cfg, device="cpu")
    kw = dict(num_slots=2, max_seq=48, prefill_bucket=16, paged=True, page_size=16,
              num_pages=6, decode_block=4)
    jeng = JaxEngine(jmodel, jcfg, **kw)
    eng = ServingEngine(model, cfg, **kw)
    a, c = list(range(1, 17)), list(range(100, 132))
    d = list(range(200, 220))
    stream = [(a + [7], 3), (a + [8, 9], 3), (c + [5], 4), (d, 10), (c + [1, 2], 3),
              (a + [6], 2)]
    for uid, (prompt, new) in enumerate(stream):
        jeng.submit(JaxRequest(uid=uid, prompt=prompt, max_new_tokens=new))
        eng.submit(GenerationRequest(uid=uid, prompt=prompt, max_new_tokens=new))
    steps = 0
    while jeng.active or jeng.queue:
        jeng.step()
        eng.step()
        steps += 1
        assert eng._slot_pages == jeng._slot_pages, steps
        assert eng._free_pages == jeng._free_pages, steps
        assert eng._page_refs == jeng._page_refs, steps
        assert eng._prefix_entries == jeng._prefix_entries, steps
        assert len(eng.queue) == len(jeng.queue) and set(eng.active) == set(jeng.active), steps
    assert not (eng.active or eng.queue)
    assert eng.prefix_stats == jeng.prefix_stats
    assert eng.prefix_stats["hits"] >= 2 and eng.prefix_stats["evictions"] >= 1, eng.prefix_stats
    assert {u: len(t) for u, t in eng.finished.items()} == {
        u: len(t) for u, t in jeng.finished.items()} == {u: n for u, (_, n) in enumerate(stream)}
    assert_greedy_under_jax(jmodel, jcfg, [p for p, _ in stream],
                            [eng.finished[u] for u in range(len(stream))])


# -- decode blocks (tests/test_serving.py) -----------------------------------

PROMPTS = {0: [1, 2, 3], 1: [9, 8], 2: [4]}


def test_decode_block_lengths_and_content(tiny):
    model, cfg = tiny
    reqs = [GenerationRequest(uid=u, prompt=p, max_new_tokens=6) for u, p in PROMPTS.items()]
    eng1, out1 = _run(model, cfg, reqs)
    engd, outd = _run(model, cfg, reqs, decode_block=4)
    assert outd == out1 and all(len(v) == 6 for v in out1.values())
    for uid in PROMPTS:
        np.testing.assert_allclose(engd.finished_logprobs[uid], eng1.finished_logprobs[uid],
                                   rtol=0, atol=0)


def test_u4_turbo_model_with_decode_block(tiny):
    model, cfg = tiny
    reqs = [GenerationRequest(uid=u, prompt=p, max_new_tokens=5)
            for u, p in list(PROMPTS.items())[:2]]
    _, out1 = _run(model, cfg, reqs)
    _, outu = _run(as_u4_turbo(model), cfg, reqs, decode_block=3)
    assert {u: len(t) for u, t in outu.items()} == {u: len(t) for u, t in out1.items()} == \
        {0: 5, 1: 5}


def test_decode_block_eos_stops_early(tiny):
    model, cfg = tiny
    _, first = _run(model, cfg, [GenerationRequest(uid=0, prompt=[1, 2], max_new_tokens=8)],
                    decode_block=4)
    eos = first[0][1]  # second generated token (mid-block)
    _, out = _run(model, cfg, [GenerationRequest(uid=1, prompt=[1, 2], max_new_tokens=8,
                                                 eos_token=eos)], decode_block=4)
    assert out[1][-1] == eos and len(out[1]) < 8 and eos not in out[1][:-1]


def test_decode_block_slot_reuse_isolation(tiny):
    model, cfg = tiny
    reqs = [GenerationRequest(uid=0, prompt=[9, 9, 9, 9], max_new_tokens=5),
            GenerationRequest(uid=1, prompt=[3, 4, 5], max_new_tokens=4)]
    _, out = _run(model, cfg, reqs, num_slots=1, decode_block=3)
    _, out2 = _run(model, cfg, [GenerationRequest(uid=2, prompt=[3, 4, 5], max_new_tokens=4)],
                   num_slots=1, decode_block=3)
    assert out[1] == out2[2]


def test_decode_block_sampling_and_generate_default(tiny):
    """Sampling runs inside the block; generate() defaults to JAX's
    decode_block of 8 and gives the single-step engine's greedy tokens."""
    model, cfg = tiny
    _, out = _run(model, cfg, [GenerationRequest(uid=0, prompt=[1, 2, 3], max_new_tokens=9)],
                  decode_block=4, sampler=Sampler(temperature=0.8, top_k=5), seed=3)
    assert len(out[0]) == 9 and all(0 <= t < cfg.vocab_size for t in out[0])
    prompts = [[5, 17, 300, 2], list(range(40, 51))]
    toks = generate(model, cfg, prompts, max_new_tokens=10, max_seq=32, prefill_bucket=8)
    single = generate(model, cfg, prompts, max_new_tokens=10, max_seq=32, prefill_bucket=8,
                      decode_block=1)
    assert toks == single and [len(t) for t in toks] == [10, 10]
