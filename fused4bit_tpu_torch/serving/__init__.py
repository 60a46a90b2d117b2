"""Serving: continuous-batching engine, speculative decoding, and the
one-call convenience API."""
from typing import List, Optional, Sequence

from .engine import GenerationRequest, Sampler, ServingEngine
from .speculative import SpecStats, SpeculativeDecoder, speculative_generate

__all__ = [
    "GenerationRequest", "Sampler", "ServingEngine", "generate",
    "SpecStats", "SpeculativeDecoder", "speculative_generate",
]


def generate(
    model,
    cfg,
    prompts: Sequence[Sequence[int]],
    *,
    max_new_tokens: int = 32,
    max_seq: int = 512,
    num_slots: Optional[int] = None,
    prefill_bucket: int = 16,
    decode_block: int = 8,
    temperature: float = 0.0,
    seed: int = 0,
    eos_id: Optional[int] = None,
    return_logprobs: bool = False,
):
    """One-call batch generation: token prompts in, completions out.

    Runs a :class:`ServingEngine` (continuous batching, chunked prefill,
    ``decode_block`` decode steps per host round trip) and returns one token
    list per prompt, in prompt order; with ``return_logprobs`` also one
    per-token log-probability list per prompt.
    """
    n = len(prompts)
    if n == 0:
        return ([], []) if return_logprobs else []
    eng = ServingEngine(
        model, cfg, num_slots=num_slots or min(n, 8), max_seq=max_seq,
        prefill_bucket=prefill_bucket, decode_block=decode_block,
        sampler=Sampler(temperature=temperature), seed=seed,
    )
    for uid, p in enumerate(prompts):
        eng.submit(GenerationRequest(uid=uid, prompt=list(p), max_new_tokens=max_new_tokens,
                                     eos_token=eos_id))
    out = eng.run()
    toks: List[List[int]] = [out[uid] for uid in range(n)]
    if return_logprobs:
        return toks, [eng.finished_logprobs[uid] for uid in range(n)]
    return toks
