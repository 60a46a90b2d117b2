"""Continuous-batching decode engine on the contiguous INT4 KV cache.

Counterpart of ``fused4bit_tpu/serving/engine.py``:

* a fixed number of batch slots, each running one request, with per-slot KV
  lengths and positions advancing independently;
* a finished slot is refilled by prefilling the next queued request into it
  (chunked: bucket-sized chunks, the last one right-padded; the slot's
  length is rewound to the true prompt length afterwards, so the padded tail
  is junk above the length that the next decode step overwrites before it
  is read), while the other slots keep decoding one token per step;
* sampling: greedy / temperature / top-k / top-p, from a seeded
  ``torch.Generator`` on the model's device.

PyTorch runs eagerly: every prefill chunk and decode step is one call of
the model. Mesh mode, ``decode_block > 1``, paged KV and speculative
decoding are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

__all__ = ["GenerationRequest", "Sampler", "ServingEngine"]


@dataclasses.dataclass
class GenerationRequest:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_token: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Sampling config (greedy / temperature / top-k / top-p)."""

    temperature: float = 0.0       # 0 -> greedy
    top_k: int = 0                 # 0 -> full distribution
    top_p: float = 1.0             # 1 -> no nucleus truncation

    def __post_init__(self):
        # top_p == 0 would mask every token and degenerate to uniform sampling
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")

    def sample(self, logits: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """logits [B, V] -> tokens [B] i32."""
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        scaled = logits.float() / self.temperature
        if self.top_k > 0:
            cutoff = torch.topk(scaled, self.top_k, dim=-1).values[:, -1:]
            scaled = scaled.masked_fill(scaled < cutoff, -1e30)
        if self.top_p < 1.0:
            # Nucleus: a token stays if the mass strictly before it in the
            # sorted distribution is < top_p (the top-1 token always stays).
            srt = torch.sort(scaled, dim=-1, descending=True).values
            probs = torch.softmax(srt, dim=-1)
            before = torch.cumsum(probs, dim=-1) - probs
            kept = torch.where(before < self.top_p, srt, torch.full_like(srt, float("inf")))
            cutoff = kept.min(dim=-1, keepdim=True).values
            scaled = scaled.masked_fill(scaled < cutoff, -1e30)
        probs = torch.softmax(scaled, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _logprob_of(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """log softmax of logits [B, V] gathered at tokens [B] -> [B] f32."""
    lsm = torch.log_softmax(logits.float(), dim=-1)
    return lsm.gather(1, tokens.long()[:, None])[:, 0]


class ServingEngine:
    """Continuous-batching engine over a ``QuantizedTransformer``."""

    def __init__(
        self,
        model,
        cfg,
        *,
        num_slots: int = 4,
        max_seq: int = 256,
        prefill_bucket: int = 32,
        sampler: Sampler = Sampler(),
        seed: int = 0,
        on_token: Optional[Callable[[int, int, float], None]] = None,
        mesh=None,
        decode_block: int = 1,
        paged: bool = False,
        draft_model=None,
    ):
        for name, value, default in (("mesh", mesh, None), ("decode_block", decode_block, 1),
                                     ("paged", paged, False), ("draft_model", draft_model, None)):
            if value != default:
                raise NotImplementedError(f"{name}={value!r} is not ported yet")
        # The last prefill chunk is padded to a whole bucket; if buckets did
        # not tile max_seq that padded append could run past the cache.
        if max_seq % prefill_bucket != 0:
            raise ValueError(
                f"max_seq ({max_seq}) must be a multiple of prefill_bucket "
                f"({prefill_bucket}) so chunked prefill never writes past the cache"
            )
        self.model = model
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.prefill_bucket = prefill_bucket
        self.sampler = sampler
        self.device = model.device
        self.caches = model.init_cache(cfg, num_slots, max_seq)
        self.queue: Deque[GenerationRequest] = deque()
        self.active: Dict[int, GenerationRequest] = {}   # slot -> request
        self.generated: Dict[int, List[int]] = {}        # uid -> tokens
        self.finished: Dict[int, List[int]] = {}
        self.logprobs: Dict[int, List[float]] = {}       # uid -> per-token logprob
        self.finished_logprobs: Dict[int, List[float]] = {}
        # on_token(uid, token_id, logprob) runs as each token is appended
        self.on_token = on_token
        self._free = list(range(num_slots))
        self._cur = np.zeros((num_slots,), np.int32)     # last token per slot
        self._pos = np.zeros((num_slots,), np.int32)     # next position
        self._remaining = np.zeros((num_slots,), np.int32)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        # cancel() from inside on_token would mutate self.active while the
        # step iterates it: such cancels wait for the end of the step
        self._stepping = False
        self._deferred_cancels: List[int] = []

    # -- model calls ---------------------------------------------------------

    def _prefill_impl(self, prompt_row: torch.Tensor, slot: int, start_pos: int) -> torch.Tensor:
        """Prefill one slot with a bucket-padded chunk through a batch-1
        forward on that slot's cache (sliced, then merged back). Returns the
        logits of every chunk position [bucket, V]."""
        sliced = tuple(c.slice_slot(slot) for c in self.caches)
        t = prompt_row.shape[0]
        positions = (start_pos + torch.arange(t, dtype=torch.int32, device=self.device))[None, :]
        logits, sliced = self.model(prompt_row[None, :], sliced, positions)
        self.caches = tuple(full.merge_slot(part, slot) for full, part in zip(self.caches, sliced))
        return logits[0]

    def _decode_impl(self, active_mask: np.ndarray):
        """One token for every slot; inactive slots run a parked token whose
        cache write lands at their stale position, masked by length."""
        cur = torch.from_numpy(self._cur).to(self.device)
        pos = torch.from_numpy(self._pos).to(self.device)
        logits, self.caches = self.model(cur[:, None], self.caches, pos[:, None])
        nxt = self.sampler.sample(logits[:, 0], self._generator)
        nxt = torch.where(torch.from_numpy(active_mask).to(self.device), nxt, 0)
        return nxt, _logprob_of(logits[:, 0], nxt)

    # -- public API ----------------------------------------------------------

    def submit(self, req: GenerationRequest) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        while self._free and self.queue:
            slot = self._free.pop()
            req = self.queue.popleft()
            prompt = np.asarray(req.prompt, np.int32)
            true_len = len(prompt)
            bucket = self.prefill_bucket
            if true_len > self.max_seq - 1:
                raise ValueError(
                    f"prompt length {true_len} exceeds cache budget "
                    f"{self.max_seq - 1} (max_seq={self.max_seq})"
                )
            num_chunks = max(1, -(-true_len // bucket))
            rem = true_len - (num_chunks - 1) * bucket  # tokens in the last chunk
            for c in range(num_chunks):
                start = c * bucket
                chunk = prompt[start: min(start + bucket, true_len)]
                padded = np.pad(chunk, (0, bucket - len(chunk)))
                logits_all = self._prefill_impl(
                    torch.from_numpy(padded).to(self.device), slot, start)
            for c in self.caches:  # rewind the padded tail
                c.lengths[slot] = true_len
            last = logits_all[rem - 1][None, :]
            nxt_t = self.sampler.sample(last, self._generator)
            nxt = int(nxt_t[0])
            lp0 = float(_logprob_of(last, nxt_t)[0])
            self.active[slot] = req
            self.generated[req.uid] = [nxt]
            self.logprobs[req.uid] = [lp0]
            if self.on_token is not None:
                self.on_token(req.uid, nxt, lp0)
            self._cur[slot] = nxt
            self._pos[slot] = true_len
            # Never let a slot write past max_seq: budget = positions left
            # after the prompt, minus 1 for the step in flight.
            self._remaining[slot] = min(req.max_new_tokens - 1, self.max_seq - true_len - 1)
            if self._remaining[slot] <= 0 or nxt == req.eos_token:
                self._retire(slot)

    def _retire(self, slot: int) -> None:
        req = self.active.pop(slot)
        self.finished[req.uid] = self.generated.pop(req.uid)
        self.finished_logprobs[req.uid] = self.logprobs.pop(req.uid, [])
        self.caches = tuple(c.reset_slot(slot) for c in self.caches)
        self._free.append(slot)

    def step(self) -> int:
        """Admit queued requests, then decode one token for every active
        slot; returns the number of active slots."""
        self._stepping = True
        try:
            with torch.no_grad():
                return self._step_inner()
        finally:
            self._stepping = False
            self._flush_deferred_cancels()

    def _step_inner(self) -> int:
        self._admit()
        if not self.active:
            return 0
        active_mask = np.zeros((self.num_slots,), bool)
        active_mask[list(self.active)] = True
        nxt, lps = self._decode_impl(active_mask)
        nxt = nxt.cpu().numpy()
        lps = lps.cpu().numpy()
        self._pos += active_mask.astype(np.int32)
        for slot in list(self.active):
            tok = int(nxt[slot])
            req = self.active[slot]
            self.generated[req.uid].append(tok)
            self.logprobs[req.uid].append(float(lps[slot]))
            if self.on_token is not None:
                self.on_token(req.uid, tok, float(lps[slot]))
            self._cur[slot] = tok
            self._remaining[slot] -= 1
            if self._remaining[slot] <= 0 or tok == req.eos_token:
                self._retire(slot)
        return len(self.active)

    def cancel(self, uid: int) -> bool:
        """Cancel a request by uid: removed from the queue, or retired
        mid-generation (its tokens so far land in ``finished``). Safe from an
        ``on_token`` callback: such cancels apply at the end of the step."""
        for i, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[i]
                self.finished[uid] = []
                self.finished_logprobs[uid] = []
                return True
        for slot, r in list(self.active.items()):
            if r.uid == uid:
                if self._stepping:
                    if uid not in self._deferred_cancels:
                        self._deferred_cancels.append(uid)
                else:
                    self._retire(slot)
                return True
        return False

    def _flush_deferred_cancels(self) -> None:
        for uid in self._deferred_cancels:
            for slot, r in list(self.active.items()):
                if r.uid == uid:
                    self._retire(slot)
        self._deferred_cancels.clear()

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drain the queue; returns {uid: generated tokens}."""
        for _ in range(max_steps):
            if not self.active and not self.queue:
                break
            self.step()
        return dict(self.finished)
