"""K3 and K3' with a window on the card, at the K-EXAONE cell's shapes (8 KV
heads of 128, 8 query heads each, the cell's 896 rows), against the plain
attention math (``ops.decode_attention._attention_math`` on the same card).
Skips without a CUDA card. On the card, from the repository's root:

    python3 -m pytest tests/test_torch_window_attention_chip.py -m chip -q

The contiguous cache is a window layer's ring, wrapped: 2048 positions
appended, then the 32 of a decode window. Decode runs on the cell's ring of
130 slots (a window of 128 and the one position a step appends), a chunk
on a ring of 160 (and the 32 positions the chunk appends). Imports nothing
of JAX.
"""
import pytest
import torch

from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.layers import QuantizedKVCache
from fused4bit_tpu_torch.layers.paged_kv import PagedKVCache
from fused4bit_tpu_torch.ops.decode_attention import _attention_math

B, HKV, G, D = 896, 8, 8, 128
WINDOW, CONTEXT, STEPS = 128, 2048, 32
BF16_REL_TOL = 1e-2   # chip_smoke's bar for bf16 kernels: of the largest output


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 and K3' have no CPU path")
    return torch.device("cuda", 0)


def _kv(gen, device, t, b=B):
    return [torch.randn((b, HKV, t, D), generator=gen, device=device) for _ in range(2)]


def _ring(gen, device, max_tokens):
    """A ring for forwards of ``max_tokens`` positions holding the last of
    the 2048 seeded positions."""
    cache = QuantizedKVCache.init(B, HKV, CONTEXT + 128, D, device=device, window=WINDOW,
                                  max_tokens=max_tokens)
    assert cache.ring and cache.max_seq == WINDOW + max_tokens + max_tokens % 2
    cache.append(*_kv(gen, device, CONTEXT), start=torch.zeros(B, dtype=torch.int32,
                                                               device=device))
    return cache


def _close(got, want):
    err = float((got.float() - want.float()).abs().max())
    assert err <= BF16_REL_TOL * float(want.float().abs().max()), err


@pytest.mark.chip
def test_k3_decode_over_a_wrapped_ring_and_the_same_positions_as_a_chunk(card):
    """32 decode steps over the ring (K3, one query a row) against the plain
    math, then the same 32 positions as one chunk over a ring seeded alike,
    against the plain math too. (Unlike a cache without a window, a decode
    row need not equal its chunk row bit for bit here: PERF.md section 7.)"""
    gen = torch.Generator(device=card).manual_seed(22)
    steps_kv = [_kv(gen, card, 1) for _ in range(STEPS)]
    qs = torch.randn((B, HKV * G, STEPS, D), generator=gen, device=card).bfloat16()
    seed_state = gen.get_state()
    cache = _ring(gen, card, 1)
    for s in range(STEPS):
        cache.append(*steps_kv[s], start=torch.full((B,), CONTEXT + s, dtype=torch.int32,
                                                    device=card))
        before = ops.int4_attention.window_launches
        got = ops.int4_decode_attention(qs[:, :, s], cache)
        assert ops.int4_attention.window_launches == before + 1
        starts = (cache.lengths - 1).to(torch.int32)
        _close(got, _attention_math(qs[:, :, s:s + 1], cache, starts, G)[:, :, 0])
    gen.set_state(seed_state)
    chunked = _ring(gen, card, STEPS)
    k = torch.cat([kv[0] for kv in steps_kv], dim=2)
    v = torch.cat([kv[1] for kv in steps_kv], dim=2)
    starts = torch.full((B,), CONTEXT, dtype=torch.int32, device=card)
    chunked.append(k, v, start=starts)
    prefill = ops.int4_prefill_attention(qs, chunked, starts)
    _close(prefill, _attention_math(qs, chunked, starts, G))


@pytest.mark.chip
def test_k3_chunk_whose_first_queries_need_the_keys_before_it(card):
    """A chunk of 32 positions appended to the wrapped ring: its first
    queries attend to the 96 to 127 positions before it."""
    gen = torch.Generator(device=card).manual_seed(23)
    cache = _ring(gen, card, STEPS)
    starts = torch.full((B,), CONTEXT, dtype=torch.int32, device=card)
    cache.append(*_kv(gen, card, STEPS), start=starts)
    q = torch.randn((B, HKV * G, STEPS, D), generator=gen, device=card).bfloat16()
    _close(ops.int4_prefill_attention(q, cache, starts), _attention_math(q, cache, starts, G))


@pytest.mark.chip
def test_k3_paged_masks_the_window(card):
    """K3' over pages that hold every position, the window a mask: against
    the plain math over the logical view, decode and a 32-position chunk."""
    gen = torch.Generator(device=card).manual_seed(24)
    b, page, pages = 64, 128, (CONTEXT + 128) // 128
    cache = PagedKVCache.init(b, HKV, D, num_pages=b * pages + 1, page_size=page,
                              max_pages_per_slot=pages, device=card, window=WINDOW)
    for r in range(b):
        cache.assign_pages(r, range(1 + r * pages, 1 + (r + 1) * pages))
    for p0 in range(0, CONTEXT, page):      # appends stay inside a page
        cache.append(*_kv(gen, card, page, b),
                     start=torch.full((b,), p0, dtype=torch.int32, device=card))
    starts = torch.full((b,), CONTEXT, dtype=torch.int32, device=card)
    cache.append(*_kv(gen, card, STEPS, b), start=starts)
    q = torch.randn((b, HKV * G, STEPS, D), generator=gen, device=card).bfloat16()
    _close(ops.int4_prefill_attention(q, cache, starts),
           _attention_math(q, cache.logical(), starts, G))
    last = (cache.lengths - 1).to(torch.int32)
    _close(ops.int4_decode_attention(q[:, :, -1], cache),
           _attention_math(q[:, :, -1:], cache.logical(), last, G)[:, :, 0])
