"""The port's continuous-batching engine on the CPU."""
import pytest
import torch

from fused4bit_tpu_torch.models import QuantizedTransformer, flagship_model_config
from fused4bit_tpu_torch.serving import GenerationRequest, Sampler, ServingEngine, generate

PROMPTS = [[5, 17, 300, 2], list(range(40, 51)), [9] * 19]   # 1, 2 and 3 prefill chunks


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


def _greedy(model, cfg, prompt, n, max_seq):
    """Plain greedy loop: one sequence, whole-prompt prefill, then decode."""
    caches = model.init_cache(cfg, 1, max_seq)
    tokens = torch.tensor([prompt], dtype=torch.int32)
    logits, caches = model(tokens, caches, torch.arange(len(prompt), dtype=torch.int32))
    out = [int(logits[0, -1].argmax())]
    for i in range(n - 1):
        pos = torch.tensor([len(prompt) + i], dtype=torch.int32)
        logits, caches = model(torch.tensor([[out[-1]]], dtype=torch.int32), caches, pos)
        out.append(int(logits[0, -1].argmax()))
    return out


def test_engine_equals_greedy_loop(tiny):
    model, cfg = tiny
    eng = ServingEngine(model, cfg, num_slots=2, max_seq=64, prefill_bucket=8)
    seen = []
    eng.on_token = lambda uid, tok, lp: seen.append(uid)
    for uid, p in enumerate(PROMPTS):
        eng.submit(GenerationRequest(uid=uid, prompt=p, max_new_tokens=6))
    with torch.no_grad():
        out = eng.run()
        want = {uid: _greedy(model, cfg, p, 6, 64) for uid, p in enumerate(PROMPTS)}
    assert out == want
    assert sorted(seen) == sorted(uid for uid in want for _ in range(6))
    assert all(len(eng.finished_logprobs[u]) == 6 for u in want)


def test_generate_and_budget(tiny):
    model, cfg = tiny
    toks = generate(model, cfg, PROMPTS[:2], max_new_tokens=3, max_seq=32, prefill_bucket=8)
    assert [len(t) for t in toks] == [3, 3]
    # a prompt near max_seq gets only the positions left in the cache
    eng = ServingEngine(model, cfg, num_slots=1, max_seq=16, prefill_bucket=8)
    eng.submit(GenerationRequest(uid=0, prompt=list(range(1, 13)), max_new_tokens=10))
    assert len(eng.run()[0]) == 16 - 12


def test_cancel_and_sampler(tiny):
    model, cfg = tiny
    eng = ServingEngine(model, cfg, num_slots=1, max_seq=32, prefill_bucket=8,
                        sampler=Sampler(temperature=0.8, top_k=5, top_p=0.9), seed=3)
    eng.submit(GenerationRequest(uid=0, prompt=[1, 2, 3], max_new_tokens=8))
    eng.submit(GenerationRequest(uid=1, prompt=[4, 5], max_new_tokens=8))
    assert eng.cancel(1)                      # queued: dropped
    eng.step()
    assert eng.cancel(0)                      # active: retired with its tokens
    out = eng.run()
    assert out[1] == [] and 1 <= len(out[0]) <= 8
    assert all(0 <= t < cfg.vocab_size for t in out[0])
    with pytest.raises(ValueError):
        Sampler(top_p=0.0)


@pytest.mark.parametrize("kw", [dict(mesh=object())])
def test_unported_modes_raise(tiny, kw):
    model, cfg = tiny
    with pytest.raises(NotImplementedError):
        ServingEngine(model, cfg, num_slots=1, max_seq=32, prefill_bucket=8, **kw)
