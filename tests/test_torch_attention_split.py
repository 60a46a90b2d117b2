"""The split-S attention body of K3/K3' (``csrc/decode_attention.cu``, bf16
queries), in what the CPU can check: a plain-torch model of its segmented
online softmax with the ordered merges, held against the JAX package's
attention in interpret mode; the exact identity of an empty segment; the
equality of a decode row and the same position's row of a chunked prefill;
and the segment rule's inputs.

The model repeats the body's arithmetic where it is fixed: raw = q . codes
(the codes 0..15, bf16 q, summed exactly and rounded once, as the tensor
cores sum in f32), scores = (raw * ks - qsum * (ks * kz)) / sqrt(D), the
mask on true positions, per segment of ``seg`` positions an online softmax
in blocks of 64 (block max, alpha = exp(m - m'), p = exp(s - m'), ps =
bf16(p * vs) rounded once for both the PV product and the zero-point
correction), the segment's state (m, l, acc - correction), the merge of the
4 segments of a CTA and then of the CTAs in order: M = max m, then
sum exp(m - M) * (l, acc) in order. Every sum that the tensor cores or a
lane take in an order of their own, the model takes exactly and rounds once.

Tolerance against JAX: 2e-2 (bf16 outputs of order 1, ps rounded at each
segment's running max here and at each tile's in JAX).
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.layers.kv_cache import QuantizedKVCache as JaxKVCache
from fused4bit_tpu.ops.decode_attention import int4_decode_attention as jax_decode
from fused4bit_tpu.ops.decode_attention import int4_prefill_attention as jax_prefill
from fused4bit_tpu_torch.layers import QuantizedKVCache
from fused4bit_tpu_torch.layers.kv_cache import _unpack_pairs
from fused4bit_tpu_torch.ops.decode_attention import _SEG_WARPS, _attn_ctas, _attn_segment

B, HKV, G, S, D = 2, 2, 2, 512, 64
BLOCK = 64
NEG = -1e30
SMS = 132


def _state(shape, d):
    """The empty state (m, l, acc) of query rows ``shape``: an identity."""
    return (torch.full(shape, NEG), torch.zeros(shape), torch.zeros((*shape, d)))


def merge(states):
    """Merge (m, l, acc) states in order: M = max m, f = exp(m - M), then
    f * l and f * acc added in order."""
    mx = states[0][0]
    for m, _, _ in states[1:]:
        mx = torch.maximum(mx, m)
    ll, acc = torch.zeros_like(mx), None
    for m, l, a in states:
        f = torch.exp(m - mx)
        ll = ll + f * l
        acc = f[..., None] * a if acc is None else acc + f[..., None] * a
    return mx, ll, acc


def segmented_attention(q: torch.Tensor, cache: QuantizedKVCache, starts: torch.Tensor,
                        seg: int) -> torch.Tensor:
    """The body in plain torch: q [B, Hq, T, D] -> [B, Hq, T, D] in q.dtype."""
    b, hq, t, d = q.shape
    g = hq // cache.k_packed.shape[1]
    s_max = cache.max_seq
    rep = lambda a: a.repeat_interleave(g, dim=1)                       # noqa: E731
    kc = rep(_unpack_pairs(cache.k_packed)).double()                     # [B, Hq, S, D] codes
    vc = rep(_unpack_pairs(cache.v_packed)).double()
    ks, kz, vs, vz = (rep(p)[:, :, None, :] for p in
                      (cache.k_scale, cache.k_zp, cache.v_scale, cache.v_zp))  # [B, Hq, 1, S]
    qd = q.double()
    qsum = qd.sum(-1, keepdim=True).float()                              # [B, Hq, T, 1]
    raw = (qd @ kc.transpose(-1, -2)).float()                            # exact, rounded once
    scores = (raw * ks - qsum * (ks * kz)) * (1.0 / math.sqrt(d))
    pos = torch.arange(s_max)
    qpos = starts.long()[:, None] + torch.arange(t)                      # [B, T]
    valid = ((pos[None, None, :] < cache.lengths.long()[:, None, None])
             & (pos[None, None, :] <= qpos[:, :, None]))[:, None]        # [B, 1, T, S]
    scores = torch.where(valid, scores, torch.tensor(NEG))

    def segment(lo):
        m, l, acc = _state((b, hq, t), d)
        cz = torch.zeros((b, hq, t))
        for bs in range(lo, min(lo + seg, s_max), BLOCK):
            blk = slice(bs, min(bs + BLOCK, s_max))
            sc, ok = scores[..., blk], valid[..., blk]
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(sc - m_new[..., None]), torch.zeros(()))
            ps = (p * vs[..., blk]).bfloat16()
            l = alpha * l + p.double().sum(-1).float()
            cz = alpha * cz + (ps.double() * vz[..., blk]).sum(-1).float()
            acc = alpha[..., None] * acc + (ps.double() @ vc[:, :, blk]).float()
            m = m_new
        return m, l, acc - cz[..., None]

    ctas = []
    for z in range(_attn_ctas(s_max, seg)):
        first = z * _SEG_WARPS * seg
        ctas.append(merge([segment(first + w * seg) for w in range(_SEG_WARPS)]))
    _, l, acc = merge(ctas) if len(ctas) > 1 else ctas[0]
    out = torch.where(l[..., None] > 0, acc / l[..., None], torch.zeros(()))
    return out.to(q.dtype)


def _filled(rng, steps):
    """A port cache after the appends steps = [(starts, T), ...], and the JAX
    cache holding the same bytes (the two packages' appends give the same
    bytes: tests/test_torch_attention.py)."""
    c = QuantizedKVCache.init(B, HKV, S, D, device="cpu")
    for starts, t in steps:
        k = rng.standard_normal((B, HKV, t, D)).astype(np.float32)
        v = rng.standard_normal((B, HKV, t, D)).astype(np.float32)
        c = c.append(torch.from_numpy(k), torch.from_numpy(v),
                     start=torch.tensor(starts, dtype=torch.int32))
    return c, JaxKVCache(**{f: jnp.asarray(np.array(getattr(c, f).numpy()))
                            for f in QuantizedKVCache._FIELDS})


def _bf16(rng, shape):
    """A bf16 query as numpy f32 values (exactly the bf16 the model reads)."""
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()


def test_segmented_decode_matches_jax(rng):
    """Decode at lengths 461 and 201, at segments of 64 (2 CTAs of 4
    segments, the longer row's last segment half full) and of 128 (one CTA)."""
    c, jc = _filled(rng, [([0, 0], 200), ([200, 200], 260), ([460, 200], 1)])
    assert c.lengths.tolist() == [461, 201]
    q = _bf16(rng, (B, HKV * G, D))
    ref = np.asarray(jax_decode(jnp.asarray(q.float().numpy(), jnp.bfloat16), jc)
                     .astype(jnp.float32))
    for seg in (64, 128):
        got = segmented_attention(q[:, :, None], c, c.lengths - 1, seg)[:, :, 0]
        assert np.max(np.abs(got.float().numpy() - ref)) <= 2e-2, seg


def test_segmented_prefill_matches_jax(rng):
    """A chunk of 9 queries per row from positions 120 and 301 (a segment
    boundary at 128 and a CTA boundary at 256 inside the chunks' spans)."""
    c, jc = _filled(rng, [([0, 0], 301), ([120, 301], 9)])
    q = _bf16(rng, (B, HKV * G, 9, D))
    starts = np.asarray([120, 301], np.int32)
    ref = np.asarray(jax_prefill(jnp.asarray(q.float().numpy(), jnp.bfloat16), jc,
                                 jnp.asarray(starts)).astype(jnp.float32))
    got = segmented_attention(q, c, torch.from_numpy(starts), 64)
    assert np.max(np.abs(got.float().numpy() - ref)) <= 2e-2


def test_empty_segment_merges_as_an_exact_identity(rng):
    """An empty segment (m = -1e30, l = 0, acc = 0) merged before, between
    or after real ones leaves their merge bit for bit: its factor exp(-1e30 -
    M) is 0 and the real sides' exp(0) is 1; and merging only empties stays
    empty (l = 0: the output is 0)."""
    shape = (3, 5)
    real = [(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) * 4,
             torch.from_numpy(rng.random(shape).astype(np.float32)) + 0.5,
             torch.from_numpy(rng.standard_normal((*shape, 8)).astype(np.float32)))
            for _ in range(2)]
    empty = _state(shape, 8)
    want = merge(real)
    for states in ([real[0], real[1], empty], [real[0], empty, real[1]],
                   [empty, real[0], real[1]], [real[0], real[1], empty, empty]):
        got = merge(states)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    one = merge([real[0], empty])
    assert all(torch.equal(a, b) for a, b in zip(one, merge([real[0]])))
    m, l, acc = merge([empty, empty])
    assert torch.equal(l, torch.zeros(shape)) and torch.equal(acc, torch.zeros((*shape, 8)))


@pytest.mark.parametrize("query", [4, 3, 2, 0])
def test_decode_rows_equal_prefill_rows_bit_for_bit(rng, query):
    """The self-draft verify's case: a T = 5 chunk whose query ``query``
    sits at each row's decode position p gives, at that query, the decode
    output bit for bit (the chunk walks more segments and blocks, all masked
    for that row, and its other rows differ)."""
    c, _ = _filled(rng, [([0, 0], 300), ([300, 300], 100)])
    pos = torch.tensor([399, 130])                                       # decode positions
    q = _bf16(rng, (B, HKV * G, D))
    c.lengths.copy_((pos + 1).to(torch.int32))
    dec = segmented_attention(q[:, :, None], c, pos.to(torch.int32), 64)[:, :, 0]
    starts = (pos - query).to(torch.int32)
    q5 = _bf16(rng, (B, HKV * G, 5, D))
    q5[:, :, query] = q
    c.lengths.copy_(starts + 5)
    pre = segmented_attention(q5, c, starts, 64)
    assert torch.equal(pre[:, :, query], dec)


def test_segment_rule_reads_no_length_and_no_t():
    """The segment size reads the positions per row, the kv heads and the
    SM count, never the lengths, T or the batch; it is a multiple of the
    64-position block, the CTAs cover the row, and at 16384 positions a
    batch of one gives about one CTA per SM."""
    assert list(inspect.signature(_attn_segment).parameters) == ["s", "h_kv", "sms"]
    for s in (64, 256, 320, 4096, 16384, 65536):
        seg = _attn_segment(s, 8, SMS)
        z = _attn_ctas(s, seg)
        assert seg % BLOCK == 0
        assert (z - 1) * _SEG_WARPS * seg < s <= z * _SEG_WARPS * seg
    assert 0.9 * SMS <= 8 * _attn_ctas(16384, _attn_segment(16384, 8, SMS)) <= 2 * SMS
    assert _attn_ctas(256, _attn_segment(256, 8, SMS)) == 1    # the serving cache: one pass
