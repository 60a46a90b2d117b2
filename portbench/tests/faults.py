"""Faults planted under the timed path, for the test that sees ``correct``
come out false: each is a context manager that breaks the program in
place and mends it on exit."""
from __future__ import annotations

import contextlib

import torch

from fused4bit_tpu_torch.layers.kv_cache import QuantizedKVCache
from fused4bit_tpu_torch.models import QuantizedTransformer


@contextlib.contextmanager
def _patched(cls, name, fn):
    old = getattr(cls, name)
    setattr(cls, name, fn(old))
    try:
        yield
    finally:
        setattr(cls, name, old)


def state_unchanged():
    """Every cache append returns its state unchanged: the step writes no
    K/V and no length."""
    return _patched(QuantizedKVCache, "append", lambda old: lambda self, *a, **k: self)


def half_batch():
    """Each forward of two or more rows keeps the first half of the batch and
    gives every other row the mean of the kept rows' logits."""
    def wrap(old):
        def forward(self, tokens, caches, positions):
            logits, caches = old(self, tokens, caches, positions)
            b = logits.shape[0]
            if b >= 2:
                keep = (b + 1) // 2
                mean = logits[:keep].mean(dim=0, keepdim=True)
                logits = torch.cat([logits[:keep], mean.expand(b - keep, *logits.shape[1:])])
            return logits, caches
        return forward
    return _patched(QuantizedTransformer, "forward", wrap)


def token_altered():
    """Row 0's token is altered where it is produced: at every forward its
    least likely token is lifted above the best, so greedy decoding picks it."""
    def wrap(old):
        def forward(self, tokens, caches, positions):
            logits, caches = old(self, tokens, caches, positions)
            logits = logits.clone()
            worst = logits[0].argmin(dim=-1)                      # [T]
            logits[0, torch.arange(logits.shape[1]), worst] = logits.max() + 1
            return logits, caches
        return forward
    return _patched(QuantizedTransformer, "forward", wrap)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "token_altered": token_altered}
