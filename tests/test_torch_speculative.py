"""The port's speculative decoding on the `tiny` model on the CPU: the tests
of tests/test_speculative.py, repeated on the port. The output must be a
greedy target trajectory: every emitted token is the argmax of a fresh
teacher-forced target forward over prompt + output, or the runner-up inside
JAX's near-tie band (the verify forward at T = gamma+1 and the single-step
forward round in another order)."""
import dataclasses

import numpy as np
import pytest
import torch

from fused4bit_tpu_torch.models import QuantizedTransformer, flagship_model_config, model_from_jax
from fused4bit_tpu_torch.serving import (
    GenerationRequest,
    Sampler,
    ServingEngine,
    SpeculativeDecoder,
    speculative_generate,
)
from test_torch_paged_engine import assert_greedy_under_jax, jax_params

TIE_BAND = 0.2  # bf16 logits: a handful of ulps at |logit| ~ 4 (tests/test_speculative.py)


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
def models():
    cfg = flagship_model_config("tiny")
    target = QuantizedTransformer.init(cfg, generator=torch.Generator().manual_seed(0),
                                       device="cpu")
    draft = QuantizedTransformer.init(cfg, generator=torch.Generator().manual_seed(7),
                                      device="cpu")
    return cfg, target, draft


def _perturbed(target, amplitude=5e-4):
    """A copy of the target with a slightly perturbed embedding: it agrees
    often but not always, so the correction path and its rollback run."""
    noise = torch.from_numpy(np.random.default_rng(3).standard_normal(
        tuple(target.embed.shape)).astype(np.float32))
    draft = QuantizedTransformer(
        (target.embed.float() + amplitude * noise).to(target.embed.dtype), target.blocks,
        target.final_norm, target.lm_head, rms_eps=target.rms_eps)
    return draft


def assert_greedy_trajectory(model, cfg, prompt, out):
    seq = list(prompt) + list(out)
    caches = model.init_cache(cfg, 1, ((len(seq) + 2) // 2) * 2)
    with torch.no_grad():
        logits, _ = model(torch.tensor([seq[:-1]], dtype=torch.int32), caches,
                          torch.arange(len(seq) - 1, dtype=torch.int32))
    for i, tok in enumerate(out):
        row = logits[0, len(prompt) - 1 + i].float().numpy()
        top2 = np.argsort(row)[-2:][::-1]
        gap = float(row[top2[0]] - row[top2[1]])
        assert tok == top2[0] or (tok == top2[1] and gap < TIE_BAND), (
            f"token {tok} at step {i} is not greedy: top2={top2.tolist()} gap={gap}")


def test_self_draft_full_acceptance(models):
    cfg, target, _ = models
    dec = SpeculativeDecoder(target, target, cfg, cfg, gamma=3)
    prompts = [[1, 2, 3], [9, 4]]
    out = dec.generate(prompts, max_new_tokens=9)
    assert dec.stats.acceptance_rate == 1.0, dec.stats
    assert [len(o) for o in out] == [9, 9]
    for p, o in zip(prompts, out):
        assert_greedy_trajectory(target, cfg, p, o)


def test_independent_draft_is_still_greedy(models):
    cfg, target, draft = models
    prompts = [[1, 2, 3], [9, 4]]
    out, stats = speculative_generate(target, draft, cfg, cfg, prompts, gamma=4,
                                      max_new_tokens=10)
    assert [len(o) for o in out] == [10, 10]
    assert stats.acceptance_rate < 1.0, stats
    for p, o in zip(prompts, out):
        assert_greedy_trajectory(target, cfg, p, o)


def test_partial_acceptance_with_correlated_draft(models):
    cfg, target, _ = models
    prompts = [[1, 2, 3], [9, 4]]
    out, stats = speculative_generate(target, _perturbed(target), cfg, cfg, prompts, gamma=4,
                                      max_new_tokens=12)
    assert [len(o) for o in out] == [12, 12]
    assert 0.0 < stats.acceptance_rate < 1.0, stats
    for p, o in zip(prompts, out):
        assert_greedy_trajectory(target, cfg, p, o)


def test_eos_truncation(models):
    cfg, target, draft = models
    full, _ = speculative_generate(target, draft, cfg, cfg, [[1, 2, 3]], gamma=4,
                                   max_new_tokens=12)
    eos = full[0][4]
    out, _ = speculative_generate(target, draft, cfg, cfg, [[1, 2, 3]], gamma=4,
                                  max_new_tokens=12, eos_id=eos)
    assert eos in out[0] and out[0][out[0].index(eos):] == [eos] and len(out[0]) <= 12
    assert_greedy_trajectory(target, cfg, [1, 2, 3], out[0])


def test_variable_length_prompts(models):
    cfg, target, draft = models
    prompts = [[5], [1, 2, 3, 4, 5, 6, 7], [9, 4, 2]]
    out, _ = speculative_generate(target, draft, cfg, cfg, prompts, gamma=3, max_new_tokens=6)
    assert [len(o) for o in out] == [6, 6, 6]
    for p, o in zip(prompts, out):
        assert_greedy_trajectory(target, cfg, p, o)


def test_engine_speculative_continuous_batching(models):
    cfg, target, _ = models
    eng = ServingEngine(target, cfg, num_slots=2, max_seq=64, prefill_bucket=8,
                        draft_model=_perturbed(target), spec_gamma=3)
    prompts = {0: [1, 2, 3], 1: [9, 4], 2: [5, 6, 7, 8]}
    for uid, p in prompts.items():
        eng.submit(GenerationRequest(uid=uid, prompt=p, max_new_tokens=7))
    out = eng.run()
    assert set(out) == {0, 1, 2} and all(len(v) == 7 for v in out.values())
    assert eng.spec_stats.rounds > 0
    for uid, p in prompts.items():
        assert_greedy_trajectory(target, cfg, p, out[uid])
        lps = eng.finished_logprobs[uid]
        assert len(lps) == 7 and all(x <= 0.0 for x in lps)


def test_engine_self_draft_matches_plain_engine(models):
    cfg, target, _ = models
    eng = ServingEngine(target, cfg, num_slots=2, max_seq=64, prefill_bucket=8,
                        draft_model=target, spec_gamma=3)
    plain = ServingEngine(target, cfg, num_slots=2, max_seq=64, prefill_bucket=8)
    for e in (eng, plain):
        e.submit(GenerationRequest(uid=0, prompt=[1, 2, 3], max_new_tokens=8))
        e.submit(GenerationRequest(uid=1, prompt=[7, 7], max_new_tokens=6))
    out_s, out_p = eng.run(), plain.run()
    assert eng.spec_stats.acceptance_rate == 1.0
    for uid, prompt in ((0, [1, 2, 3]), (1, [7, 7])):
        assert len(out_s[uid]) == len(out_p[uid]) and out_s[uid][0] == out_p[uid][0]
        assert_greedy_trajectory(target, cfg, prompt, out_s[uid])


def test_engine_spec_eos_stops(models):
    cfg, target, _ = models
    kw = dict(num_slots=1, max_seq=64, prefill_bucket=8, draft_model=target, spec_gamma=3)
    eng = ServingEngine(target, cfg, **kw)
    eng.submit(GenerationRequest(uid=0, prompt=[1, 2], max_new_tokens=10))
    eos = eng.run()[0][3]
    eng2 = ServingEngine(target, cfg, **kw)
    eng2.submit(GenerationRequest(uid=0, prompt=[1, 2], max_new_tokens=10, eos_token=eos))
    out = eng2.run()[0]
    assert eos in out and out[out.index(eos):] == [eos]


def test_speculative_matches_jax():
    """JAX's speculative_generate and the port's on the same `tiny` target
    and drafts (the port's from JAX's leaves), self-draft and an independent
    draft: the same rounds, drafted and accepted counts, and every token of
    the port greedy under JAX's teacher-forced target forward."""
    import jax

    from fused4bit_tpu.models.config import flagship_model_config as jax_config
    from fused4bit_tpu.models.transformer import QuantizedTransformer as JaxTransformer
    from fused4bit_tpu.serving.speculative import speculative_generate as jax_speculative

    jcfg, cfg = jax_config("tiny"), flagship_model_config("tiny")
    jtarget = JaxTransformer.init(jax.random.PRNGKey(0), jcfg)
    jdraft = JaxTransformer.init(jax.random.PRNGKey(7), jcfg)
    target, draft = (model_from_jax(jax_params(m), cfg, device="cpu") for m in (jtarget, jdraft))
    prompts = [[1, 2, 3], [9, 4]]
    outs = []
    for jd, d in ((jtarget, target), (jdraft, draft)):
        jout, jstats = jax_speculative(jtarget, jd, jcfg, jcfg, prompts, gamma=4,
                                       max_new_tokens=10)
        with torch.no_grad():
            out, stats = speculative_generate(target, d, cfg, cfg, prompts, gamma=4,
                                              max_new_tokens=10)
        assert dataclasses.astuple(stats) == dataclasses.astuple(jstats)
        assert [len(o) for o in out] == [len(o) for o in jout] == [10, 10]
        outs += out
    assert_greedy_under_jax(jtarget, jcfg, prompts * 2, outs)


def test_engine_with_a_smaller_draft_config(models):
    """The engine's draft_cfg path: a draft of another shape (1 layer, 1 KV
    head, hidden 256) gets caches of its own shape and a per-slot prefill;
    the output is still the target's greedy trajectory. A draft vocabulary
    that differs from the target's is refused."""
    cfg, target, _ = models
    draft_cfg = dataclasses.replace(cfg, num_layers=1, num_kv_heads=1,
                                    moe=dataclasses.replace(cfg.moe, hidden_dim=256, ffn_dim=512))
    draft = QuantizedTransformer.init(draft_cfg, generator=torch.Generator().manual_seed(5),
                                      device="cpu")
    eng = ServingEngine(target, cfg, num_slots=2, max_seq=64, prefill_bucket=8,
                        draft_model=draft, draft_cfg=draft_cfg, spec_gamma=3)
    assert len(eng.draft_caches) == 1 and eng.draft_caches[0].k_packed.shape[1] == 1
    prompts = {0: [1, 2, 3], 1: [9, 4], 2: [5, 6, 7, 8, 9, 10, 11, 12, 13]}
    for uid, p in prompts.items():
        eng.submit(GenerationRequest(uid=uid, prompt=p, max_new_tokens=6))
    out = eng.run()
    assert {u: len(t) for u, t in out.items()} == {0: 6, 1: 6, 2: 6}
    assert eng.spec_stats.rounds > 0
    for uid, p in prompts.items():
        assert_greedy_trajectory(target, cfg, p, out[uid])
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(target, cfg, num_slots=1, max_seq=64, prefill_bucket=8, draft_model=draft,
                      draft_cfg=dataclasses.replace(draft_cfg, vocab_size=513))


@pytest.mark.parametrize("kw, match", [
    (dict(decode_block=4), "decode_block"),
    (dict(sampler=Sampler(temperature=1.0)), "greedy"),
    (dict(paged=True, page_size=16), "single-chip"),
    (dict(mesh=object()), "single-chip"),
])
def test_engine_spec_mode_validation(models, kw, match):
    cfg, target, draft = models
    with pytest.raises(ValueError, match=match):
        ServingEngine(target, cfg, num_slots=1, max_seq=64, prefill_bucket=8,
                      draft_model=draft, **kw)


def test_spec_budget_and_decoder_validation(models):
    cfg, target, draft = models
    eng = ServingEngine(target, cfg, num_slots=1, max_seq=16, prefill_bucket=8,
                        draft_model=draft, spec_gamma=3)
    eng.submit(GenerationRequest(uid=0, prompt=[1] * 12, max_new_tokens=4))
    with pytest.raises(ValueError, match="prompt length"):
        eng.run()   # 12 > 16 - 1 - (gamma + 1)
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeDecoder(target, draft, cfg, dataclasses.replace(cfg, vocab_size=513))
    with pytest.raises(ValueError, match="gamma"):
        SpeculativeDecoder(target, draft, cfg, cfg, gamma=0)
    dec = SpeculativeDecoder(target, draft, cfg, cfg, gamma=2)
    with pytest.raises(ValueError, match="max_seq"):
        dec.generate([[1, 2]], max_new_tokens=8, max_seq=10)
    with pytest.raises(ValueError, match="non-empty"):
        dec.generate([[1], []])
