"""Continuous-batching decode engine over the INT4 KV cache.

Counterpart of ``fused4bit_tpu/serving/engine.py``:

* a fixed number of batch slots, each running one request, with per-slot KV
  lengths and positions advancing independently;
* a finished slot is refilled by prefilling the next queued request into it
  (chunked: bucket-sized chunks, the last one right-padded; the slot's
  length is rewound to the true prompt length afterwards, so the padded tail
  is junk above the length that the next decode step overwrites before it
  is read), while the other slots keep decoding;
* sampling: greedy / temperature / top-k / top-p, from a seeded
  ``torch.Generator`` on the model's device;
* ``decode_block``: D decode steps per :meth:`ServingEngine.step`, a loop
  over device tensors with sampling and the retirement masks on the device
  and one device-to-host copy per block;
* ``paged``: a ``PagedKVCache`` pool with a host page allocator, admission
  control (a request waits at the head of the queue until retirements free
  enough pages) and prefix caching (requests whose prompts share full pages
  share the physical pages and skip their prefill);
* ``draft_model``: speculative rounds (``serving.speculative``), greedy;
* ``mesh``: every forward through the sharded model step
  (``parallel.sharded_decode_step``: DP batch x EP experts). Every rank runs
  this same scheduler on the same requests, holds the caches of its `data`
  shard of the slots, and samples from the same gathered logits.

PyTorch runs eagerly: every prefill chunk and decode step is one call of
the model.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..parallel.mesh import axis_index, axis_size
from ..parallel.sharded_model import sharded_decode_step
from .speculative import SpecStats, SpeculativeDecoder, _rollback

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
        page_size: int = 128,
        num_pages: Optional[int] = None,
        prefix_caching: bool = True,
        draft_model=None,
        draft_cfg=None,
        spec_gamma: int = 4,
    ):
        """``mesh``: a ``DeviceMesh`` with a `data` and an `expert` axis
        (``parallel.make_mesh``); ``model`` must be placed on it
        (``parallel.place_model``) and ``num_slots`` must divide by the
        `data` size. Rank d of `data` holds the caches of slots
        [d * num_slots / D, (d + 1) * num_slots / D). A prefill chunk runs
        the full batch, every other row parked in the reserved tail
        [max_seq - prefill_bucket, max_seq) and its length rewound, so each
        request's budget keeps ``prefill_bucket`` positions clear. Paged and
        speculative serving are single-card.

        ``decode_block``: decode steps per :meth:`step`, run as one loop
        over device tensors (sampling and the EOS/budget masks on the
        device) with one device-to-host copy at the end; slots that finish
        mid-block idle, parked, until the block ends.

        ``paged``: a shared pool of ``num_pages`` pages of ``page_size``
        positions (default ``num_slots * max_seq / page_size + 1``; page 0
        is reserved) instead of ``max_seq`` positions per slot. A request
        takes the pages its prompt and budget need, or waits.
        ``prefix_caching`` shares full prompt pages between requests.

        ``draft_model``/``draft_cfg``/``spec_gamma``: speculative rounds of
        ``spec_gamma`` draft tokens and one verify forward per step; greedy,
        contiguous cache, ``decode_block=1``.
        """
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
        self.mesh = mesh
        data, data_index = 1, 0
        if mesh is not None:
            if any(hasattr(blk.attn, "kv_lora_rank") for blk in model.blocks):
                raise ValueError("multi-head latent attention is single-chip for now (no mesh)")
            if paged:
                raise ValueError("paged KV is single-chip for now (no mesh)")
            if any(blk.attn.window for blk in model.blocks):
                # the sharded prefill parks the other rows' writes at the end
                # of the cache, which on a window layer's ring are live slots
                raise ValueError("window layers are single-chip for now (no mesh)")
            if draft_model is not None:
                raise ValueError("speculative serving is single-chip contiguous-cache for now")
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a DeviceMesh (parallel.make_mesh), got "
                                f"{type(mesh).__name__}")
            if "data" in mesh.mesh_dim_names:
                data, data_index = axis_size(mesh, "data"), axis_index(mesh, "data")
        if num_slots % data:
            raise ValueError(f"num_slots ({num_slots}) must divide by the mesh's data size "
                             f"({data})")
        self._local_slots = num_slots // data
        self._first_slot = data_index * self._local_slots   # of the caches this rank holds

        self.paged = paged
        if paged:
            if page_size % prefill_bucket != 0:
                raise ValueError(
                    f"page_size ({page_size}) must be a multiple of prefill_bucket "
                    f"({prefill_bucket}) so every prefill chunk lands inside one page"
                )
            if max_seq % page_size != 0:
                raise ValueError(f"max_seq ({max_seq}) must be a multiple of page_size "
                                 f"({page_size})")
            max_pages = max_seq // page_size
            if num_pages is None:
                # contiguous-equivalent capacity; page 0 is the reserved
                # parked page (never allocated: unused table entries and
                # retired slots' masked writes land there)
                num_pages = num_slots * max_pages + 1
            self.page_size = page_size
            self.num_pages = num_pages
            self._free_pages = list(range(num_pages - 1, 0, -1))  # pop -> 1..
            self._slot_pages: Dict[int, List[int]] = {}
            # Prefix caching: requests whose prompts share full-page token
            # prefixes point their tables at the SAME physical pages and skip
            # prefilling them (identical token prefixes give identical K/V).
            # Per-page refcounts count the slots holding a page; a page under
            # a prefix entry is RETAINED after its last holder retires, and
            # allocation pressure evicts least-recently-used entries. Only
            # full PROMPT pages register, so decode writes never touch a
            # shared page.
            self.prefix_caching = prefix_caching
            self._page_refs = [0] * num_pages
            self._prefix_entries: Dict[str, tuple] = {}   # digest -> page ids
            self._page_keys: Dict[int, set] = {}          # page -> entry digests
            self._entry_lru: Dict[str, None] = {}         # insertion order = LRU
            self.prefix_stats = {"lookups": 0, "hits": 0, "shared_tokens": 0, "evictions": 0}
            self.caches = model.init_paged_cache(cfg, num_slots, num_pages=num_pages,
                                                 page_size=page_size,
                                                 max_pages_per_slot=max_pages)
        else:
            # a window layer's ring holds its window plus the longest forward:
            # a prefill chunk, or a speculative verify of gamma + 1 positions
            max_tokens = max(prefill_bucket, spec_gamma + 1 if draft_model is not None else 1)
            self.caches = model.init_cache(cfg, self._local_slots, max_seq, max_tokens=max_tokens)
        self.queue: Deque[GenerationRequest] = deque()
        self.active: Dict[int, GenerationRequest] = {}   # slot -> request
        self.generated: Dict[int, List[int]] = {}        # uid -> tokens
        self.finished: Dict[int, List[int]] = {}
        self.logprobs: Dict[int, List[float]] = {}       # uid -> per-token logprob
        self.finished_logprobs: Dict[int, List[float]] = {}
        # on_token(uid, token_id, logprob) runs as each token is appended on
        # the host (after a decode block returns)
        self.on_token = on_token

        # Speculative continuous batching: each step is a draft round plus
        # one verify forward, 1..gamma+1 tokens per slot; rejected positions
        # are disowned by per-row length rollback (serving.speculative).
        self.draft_model = draft_model
        if draft_model is not None:
            if decode_block > 1:
                raise ValueError("draft_model replaces decode_block; use one")
            if paged:
                raise ValueError("speculative serving is single-chip contiguous-cache for now")
            if sampler.temperature != 0.0:
                raise ValueError("speculative serving is greedy-only (temperature=0)")
            self.draft_cfg = draft_cfg or cfg
            self._spec = SpeculativeDecoder(model, draft_model, cfg, self.draft_cfg,
                                            gamma=spec_gamma)
            self.spec_stats = SpecStats()
            self.draft_caches = draft_model.init_cache(self.draft_cfg, num_slots, max_seq,
                                                       max_tokens=max_tokens)
        if decode_block < 1:
            raise ValueError(f"decode_block must be >= 1, got {decode_block}")
        self.decode_block = decode_block
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

    def _forward(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """One forward of every slot: tokens and positions [B, T] of all
        slots; returns the logits [B, T, V] and updates ``self.caches``."""
        if self.mesh is None:
            logits, self.caches = self.model(tokens, self.caches, positions)
            return logits
        rows = slice(self._first_slot, self._first_slot + self._local_slots)
        logits, self.caches = sharded_decode_step(self.model, self.mesh, tokens[rows],
                                                  self.caches, positions[rows])
        return logits

    def _cache_row(self, slot: int) -> Optional[int]:
        """The row of ``slot`` in this rank's caches (None: another rank's)."""
        row = slot - self._first_slot
        return row if 0 <= row < self._local_slots else None

    def _prefill_sharded(self, prompt_row: torch.Tensor, slot: int, start_pos: int):
        """Mesh-mode prefill of one chunk: the full batch through the sharded
        step (slicing one slot would fight the data split). The target row
        carries the chunk at [start_pos, start_pos + bucket); every other row
        runs zeros parked at [max_seq - bucket, max_seq), a region no live
        row reaches (the budgets keep it clear), and its length is rewound
        afterwards. Returns the target row's logits [bucket, V]."""
        t = prompt_row.shape[0]
        b = self.num_slots
        tokens = torch.zeros((b, t), dtype=torch.int32, device=self.device)
        tokens[slot] = prompt_row
        starts = torch.full((b,), self.max_seq - t, dtype=torch.int32, device=self.device)
        starts[slot] = start_pos
        positions = starts[:, None] + torch.arange(t, dtype=torch.int32, device=self.device)
        old = [c.lengths.clone() for c in self.caches]
        logits = self._forward(tokens, positions)
        row = self._cache_row(slot)
        target = torch.arange(self._local_slots, device=self.device) == (-1 if row is None else row)
        for c, o in zip(self.caches, old):
            c.lengths.copy_(torch.where(target, c.lengths, o))
        return logits[slot]

    def _prefill_impl(self, model, caches, prompt_row: torch.Tensor, slot: int,
                      start_pos: int):
        """Prefill one slot with a bucket-padded chunk through a batch-1
        forward on that slot's cache (sliced, then merged back; a paged
        slice shares the pools, so nothing is copied). Returns the logits of
        every chunk position [bucket, V] and the caches."""
        sliced = tuple(c.slice_slot(slot) for c in caches)
        t = prompt_row.shape[0]
        positions = (start_pos + torch.arange(t, dtype=torch.int32, device=self.device))[None, :]
        logits, sliced = model(prompt_row[None, :], sliced, positions)
        caches = tuple(full.merge_slot(part, slot) for full, part in zip(caches, sliced))
        return logits[0], caches

    def _decode_block_impl(self, state: torch.Tensor) -> torch.Tensor:
        """``decode_block`` decode steps on device tensors, with no host
        sync: sampling, the EOS and budget retirement masks and the
        log-probs stay on the device. ``state`` [5, B] int32 holds cur, pos,
        remaining, eos (-1 for none) and the active flags (0/1), one host
        copy. A slot that finishes mid-block keeps running with a parked
        token (masked inactive, its position frozen): its cache writes land
        above its length and never reach a live row. Returns one int32
        tensor [3D + 4, B] for a single host copy: the tokens [D, B], the
        was-active flags [D, B], the log-probs' bits [D, B], then the final
        cur, pos, remaining and active rows."""
        cur, pos, remaining, eos, act = state.unbind(0)
        toks, acts, lps = [], [], []
        for _ in range(self.decode_block):
            logits = self._forward(cur[:, None], pos[:, None])
            active = act.bool()
            nxt = torch.where(active, self.sampler.sample(logits[:, 0], self._generator), 0)
            lps.append(_logprob_of(logits[:, 0], nxt))
            toks.append(nxt)
            acts.append(act)
            remaining = remaining - act
            cur = torch.where(active, nxt, cur)
            pos = pos + act
            act = act * ((nxt != eos) & (remaining > 0))
        return torch.cat([torch.stack(toks), torch.stack(acts),
                          torch.stack(lps).view(torch.int32),
                          torch.stack([cur, pos, remaining, act])])

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
            # mesh mode: the parked rows of every prefill write the last bucket
            reserved = bucket if self.mesh is not None else 0
            if self.draft_model is not None:
                # spec rounds write up to gamma+1 positions past `pos`
                reserved += self._spec.gamma + 1
            if true_len > self.max_seq - 1 - reserved:
                raise ValueError(
                    f"prompt length {true_len} exceeds cache budget "
                    f"{self.max_seq - 1 - reserved} (max_seq={self.max_seq})"
                )
            shared_len = 0            # prompt tokens whose K/V is reused
            shared_pages: List[int] = []
            if self.paged:
                page = self.page_size
                hit_key = None
                digests: List[str] = []
                if self.prefix_caching:
                    # Chained per-page digests; the lookup keeps the LONGEST
                    # hit, capped so >= 1 tail token still runs through
                    # prefill (its logits give token 0).
                    digests = self._prefix_digests(prompt, true_len // page)
                    n_look = min((true_len - 1) // page, len(digests))
                    if n_look > 0:
                        self.prefix_stats["lookups"] += 1
                    for i in range(n_look):
                        ent = self._prefix_entries.get(digests[i])
                        if ent is not None:
                            hit_key = digests[i]
                            shared_pages = list(ent)
                            shared_len = (i + 1) * page
                    # Pin the matched pages NOW: eviction below must never
                    # free a page this admission is about to put in its table.
                    for p in shared_pages:
                        self._page_refs[p] += 1
                # The request's whole working set up front: the padded
                # prefill AND the whole decode budget (a running slot never
                # waits for a page mid-decode).
                num_chunks = max(1, -(-(true_len - shared_len) // bucket))
                planned = min(req.max_new_tokens - 1, self.max_seq - true_len - 1)
                positions = max(shared_len + num_chunks * bucket,
                                true_len + 1 + max(planned, 0))
                pages_needed = -(-positions // page)
                if pages_needed > self.num_pages - 1:
                    raise ValueError(
                        f"request needs {pages_needed} pages; pool has "
                        f"{self.num_pages - 1} (num_pages-1; page 0 is reserved): "
                        "grow num_pages or shrink the request"
                    )
                fresh_needed = pages_needed - len(shared_pages)
                if fresh_needed > len(self._free_pages):
                    self._evict_prefix_entries(fresh_needed)  # reclaim LRU entries first
                if fresh_needed > len(self._free_pages):
                    # No room now: requeue at the front and wait for a
                    # retirement to free pages.
                    for p in shared_pages:
                        self._release_page(p)  # undo the pin
                    self.queue.appendleft(req)
                    self._free.append(slot)
                    break
                fresh = [self._free_pages.pop() for _ in range(fresh_needed)]
                pages = shared_pages + fresh
                for p in fresh:
                    self._page_refs[p] = 1
                self._slot_pages[slot] = pages
                self.caches = tuple(c.assign_pages(slot, pages) for c in self.caches)
                if self.prefix_caching:
                    if hit_key is not None:  # stats and LRU only on success
                        self.prefix_stats["hits"] += 1
                        self.prefix_stats["shared_tokens"] += shared_len
                        self._entry_lru.pop(hit_key, None)
                        self._entry_lru[hit_key] = None
                    # Register every full PROMPT page (decode writes start at
                    # true_len, past all of them); nested keys share page-list
                    # prefixes.
                    for n, key in enumerate(digests, start=1):
                        if key not in self._prefix_entries:
                            self._prefix_entries[key] = tuple(pages[:n])
                            self._entry_lru[key] = None
                            for p in pages[:n]:
                                self._page_keys.setdefault(p, set()).add(key)
            else:
                num_chunks = max(1, -(-true_len // bucket))
            # Chunked prefill of the tail past the shared prefix; the final
            # chunk is right-padded to the bucket (junk above every real
            # position, rewound below).
            tail = true_len - shared_len  # >= 1 (the lookup keeps a tail token)
            rem = tail - (num_chunks - 1) * bucket  # tokens in the final chunk
            for c in range(num_chunks):
                start = shared_len + c * bucket
                chunk = prompt[start: min(start + bucket, true_len)]
                padded = torch.from_numpy(np.pad(chunk, (0, bucket - len(chunk)))).to(self.device)
                if self.mesh is not None:
                    logits_all = self._prefill_sharded(padded, slot, start)
                else:
                    logits_all, self.caches = self._prefill_impl(self.model, self.caches, padded,
                                                                 slot, start)
                if self.draft_model is not None:
                    _, self.draft_caches = self._prefill_impl(self.draft_model, self.draft_caches,
                                                              padded, slot, start)
            row = self._cache_row(slot)
            if row is not None:
                for c in self.caches:  # rewind the padded tail
                    c.lengths[row] = true_len
            if self.draft_model is not None:
                for c in self.draft_caches:
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
            # after the prompt, minus 1 for the step in flight (and a spec
            # round's gamma+1 positions).
            budget = self.max_seq - true_len - 1 - reserved
            self._remaining[slot] = min(req.max_new_tokens - 1, budget)
            if self._remaining[slot] <= 0 or nxt == req.eos_token:
                self._retire(slot)

    def _retire(self, slot: int) -> None:
        req = self.active.pop(slot)
        self.finished[req.uid] = self.generated.pop(req.uid)
        self.finished_logprobs[req.uid] = self.logprobs.pop(req.uid, [])
        row = self._cache_row(slot)
        if row is not None:
            self.caches = tuple(c.reset_slot(row) for c in self.caches)
        if self.draft_model is not None:
            self.draft_caches = tuple(c.reset_slot(slot) for c in self.draft_caches)
            # park the retired slot at position 0: spec rounds write
            # [pos, pos+gamma+1) for EVERY row (the junk at [0, gamma+2) is
            # overwritten by the slot's next prefill from position 0)
            self._pos[slot] = 0
            self._cur[slot] = 0
        if self.paged:
            for p in self._slot_pages.pop(slot, ()):
                self._page_refs[p] -= 1
                if self._page_refs[p] == 0 and not self._page_keys.get(p):
                    # no prefix entry references it: truly free; pages under
                    # an entry are RETAINED for future hits and reclaimed by
                    # _evict_prefix_entries under pressure
                    self._free_pages.append(p)
        self._free.append(slot)

    def _prefix_digests(self, prompt: np.ndarray, n_pages: int) -> List[str]:
        """Chained SHA-256 over full prompt pages: digests[i] keys
        prompt[: (i+1)*page_size], O(prompt) work in all."""
        h = hashlib.sha256()
        out = []
        for n in range(n_pages):
            h.update(np.ascontiguousarray(
                prompt[n * self.page_size:(n + 1) * self.page_size], np.int32).tobytes())
            out.append(h.hexdigest())
        return out

    def _release_page(self, p: int) -> None:
        """Drop one reference; free the page when nothing holds OR retains it
        (an orphan pinned through its entry's eviction must not leak)."""
        self._page_refs[p] -= 1
        if self._page_refs[p] == 0 and not self._page_keys.get(p):
            self._free_pages.append(p)

    def _drop_prefix_entry(self, key: str) -> None:
        ent = self._prefix_entries.pop(key, None)
        self._entry_lru.pop(key, None)
        if not ent:
            return
        for p in ent:
            keys = self._page_keys.get(p)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._page_keys[p]
                    if self._page_refs[p] == 0:
                        self._free_pages.append(p)

    def _evict_prefix_entries(self, need: int) -> None:
        """Drop least-recently-used prefix entries until ``need`` pages are
        free, no entries remain, or nothing RECLAIMABLE remains (pages held
        or pinned by a slot survive their entries and free later through
        :meth:`_retire`; evicting past them would wipe the retained cache for
        no freed page)."""
        while need > len(self._free_pages) and self._entry_lru:
            if not any(self._page_refs[p] == 0 for p in self._page_keys):
                return  # every retained page is held; eviction is futile
            self._drop_prefix_entry(next(iter(self._entry_lru)))
            self.prefix_stats["evictions"] += 1

    def step(self) -> int:
        """Admit queued requests, then decode ``decode_block`` tokens (or one
        speculative round) for every active slot; returns the number of
        active slots."""
        self._stepping = True
        try:
            with torch.no_grad():
                return self._step_inner()
        finally:
            self._stepping = False
            self._flush_deferred_cancels()

    def _append(self, slot: int, tok: int, lp: float) -> None:
        req = self.active[slot]
        self.generated[req.uid].append(tok)
        self.logprobs[req.uid].append(lp)
        if self.on_token is not None:
            self.on_token(req.uid, tok, lp)

    def _step_inner(self) -> int:
        self._admit()
        if not self.active:
            return 0
        if self.draft_model is not None:
            return self._step_spec()
        return self._step_block()

    def _step_block(self) -> int:
        """One ``decode_block``-step block (one step at D=1): one copy each
        way between host and device."""
        d = self.decode_block
        active_mask = np.zeros((self.num_slots,), bool)
        eos = np.full((self.num_slots,), -1, np.int32)
        for s, req in self.active.items():
            active_mask[s] = True
            if req.eos_token is not None:
                eos[s] = req.eos_token
        state = np.stack([self._cur, self._pos, self._remaining, eos,
                          active_mask.astype(np.int32)])
        host = self._decode_block_impl(torch.from_numpy(state).to(self.device)).cpu().numpy()
        toks, acts = host[:d], host[d:2 * d].astype(bool)          # [D, B]
        lps = np.ascontiguousarray(host[2 * d:3 * d]).view(np.float32)
        self._cur, self._pos, self._remaining = (host[3 * d].copy(), host[3 * d + 1].copy(),
                                                 host[3 * d + 2].copy())
        final_active = host[3 * d + 3].astype(bool)
        for slot in list(self.active):
            for step_d in range(d):
                if acts[step_d, slot]:
                    self._append(slot, int(toks[step_d, slot]), float(lps[step_d, slot]))
            if not final_active[slot]:
                self._retire(slot)
        return len(self.active)

    def _step_spec(self) -> int:
        """One speculative round for every active slot: draft gamma tokens,
        verify them in ONE target forward, append each slot's accepted prefix
        and its correction or bonus token. Rejected K/V is disowned by
        rolling both models' lengths back to each row's ``pos`` at the top
        of the round; inactive slots run parked at position 0."""
        active_mask = np.zeros((self.num_slots,), bool)
        active_mask[list(self.active)] = True
        pos_arr = np.where(active_mask, self._pos, 0).astype(np.int32)
        last = np.where(active_mask, self._cur, 0).astype(np.int32)
        pos_t = torch.from_numpy(pos_arr).to(self.device)
        last_t = torch.from_numpy(last).to(self.device)
        _rollback(self.draft_caches, pos_t)
        _rollback(self.caches, pos_t)
        self.draft_caches, d_toks = self._spec._draft_round(self.draft_model, self.draft_caches,
                                                            last_t, pos_t)
        self.caches, n, emitted, lp_d, lp_e = self._spec._verify(self.model, self.caches,
                                                                  last_t, d_toks, pos_t)
        g = self._spec.gamma
        host = torch.cat([d_toks, n[:, None].to(torch.int32), emitted[:, None],
                          lp_d.contiguous().view(torch.int32),
                          lp_e[:, None].contiguous().view(torch.int32)], dim=1).cpu().numpy()
        d_np, n_np, e_np = host[:, :g], host[:, g], host[:, g + 1]
        lps_np = np.ascontiguousarray(host[:, g + 2:]).view(np.float32)   # [B, g+1]
        self.spec_stats.rounds += 1
        for slot in list(self.active):
            req = self.active[slot]
            k = int(n_np[slot])
            self.spec_stats.drafted += g
            self.spec_stats.accepted += k
            new = [int(x) for x in d_np[slot, :k]] + [int(e_np[slot])]
            lps = [float(x) for x in lps_np[slot, :k]] + [float(lps_np[slot, g])]
            kept = 0
            done = False
            for tok, lp in zip(new, lps):
                self._append(slot, tok, lp)
                kept += 1
                self._remaining[slot] -= 1
                if tok == req.eos_token or self._remaining[slot] <= 0:
                    done = True
                    break
            self._cur[slot] = self.generated[req.uid][-1]
            self._pos[slot] = pos_arr[slot] + kept
            if done:
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
