"""Speculative decoding: draft gamma tokens, verify them in one forward.

Counterpart of ``fused4bit_tpu/serving/speculative.py`` (greedy acceptance,
Leviathan et al. 2023). A draft model proposes ``gamma`` tokens one step at
a time; the target scores all of them in ONE forward over gamma+1 positions
(the chunked-prefill attention path, kernel K3 at T = gamma+1) and keeps the
longest prefix it agrees with, plus one correction or bonus token. The
output is target-only greedy decoding; acceptance decides only how many
tokens each target weight stream yields (1..gamma+1).

Rollback costs nothing: both caches are written for all gamma+1 positions
and rejected positions are disowned by writing each row's ``lengths`` back,
in place (positions above a row's length are never read and are overwritten
by the next round before its attention reads them). Per-row positions and
lengths keep rows with different acceptance counts independent.

PyTorch runs eagerly: the draft round is a loop of gamma+1 batch decode
steps on device tensors, and :meth:`SpeculativeDecoder.generate` copies the
round's drafts, acceptance counts and emitted tokens to the host once.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["SpecStats", "SpeculativeDecoder", "speculative_generate"]


@dataclasses.dataclass
class SpecStats:
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)


def _rollback(caches, lengths: torch.Tensor):
    """Every cache's per-row lengths set to ``lengths``, in place."""
    for c in caches:
        c.lengths.copy_(lengths)
    return caches


class SpeculativeDecoder:
    """Greedy speculative decoding over a (target, draft) model pair that
    shares the vocabulary."""

    def __init__(self, target, draft, cfg_target, cfg_draft, *, gamma: int = 4):
        if cfg_target.vocab_size != cfg_draft.vocab_size:
            raise ValueError("target and draft must share a vocabulary")
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        self.target = target
        self.draft = draft
        self.cfg_t = cfg_target
        self.cfg_d = cfg_draft
        self.gamma = gamma

    # -- device programs ------------------------------------------------------

    def _draft_round(self, draft, caches, last: torch.Tensor, pos: torch.Tensor):
        """gamma greedy draft steps; last, pos [B]. Returns (caches, drafts
        [B, gamma]).

        Runs gamma+1 steps: the extra one feeds d_gamma so its K/V lands in
        the draft cache, which the next round's context needs after a full
        acceptance (the d_{gamma+1} prediction itself is dropped).
        """
        tok, p, toks = last, pos, []
        for _ in range(self.gamma + 1):
            logits, caches = draft(tok[:, None], caches, p[:, None])
            tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            toks.append(tok)
            p = p + 1
        return caches, torch.stack(toks[:self.gamma], dim=1)

    def _verify(self, target, caches, last: torch.Tensor, d_toks: torch.Tensor,
                pos: torch.Tensor):
        """One (gamma+1)-token target forward over [last, d_1..d_gamma] at
        positions [pos, pos+gamma]; greedy acceptance. Returns (caches,
        n_accepted [B], emitted [B], logprobs of the drafts [B, gamma],
        logprob of the emitted token [B]); emitted is the correction token
        (first disagreement) or the bonus token (all gamma accepted)."""
        b, g = d_toks.shape
        tokens = torch.cat([last[:, None], d_toks], dim=1)
        positions = pos[:, None] + torch.arange(g + 1, dtype=torch.int32, device=pos.device)
        logits, caches = target(tokens, caches, positions)
        preds = torch.argmax(logits, dim=-1).to(torch.int32)           # [B, g+1]
        match = preds[:, :g] == d_toks
        n = torch.where(match.all(dim=1), g, torch.argmin(match.to(torch.int32), dim=1))
        emitted = preds.gather(1, n[:, None])[:, 0]
        lsm = torch.log_softmax(logits.float(), dim=-1)
        lp_drafts = lsm[:, :g].gather(2, d_toks.long()[:, :, None])[..., 0]   # [B, g]
        lsm_at_n = lsm.gather(1, n[:, None, None].expand(b, 1, lsm.shape[-1]))[:, 0]
        lp_emitted = lsm_at_n.gather(1, emitted.long()[:, None])[:, 0]        # [B]
        return caches, n, emitted, lp_drafts, lp_emitted

    def _prefill(self, target, draft, caches_t, caches_d, tokens: torch.Tensor,
                 lengths: torch.Tensor):
        """Right-padded batch prefill of both models; returns the first
        greedy token of each row (from its last real position)."""
        b, t = tokens.shape
        positions = torch.arange(t, dtype=torch.int32, device=tokens.device)[None].expand(b, t)
        logits, caches_t = target(tokens, caches_t, positions)
        _, caches_d = draft(tokens, caches_d, positions)
        last_logits = logits.gather(
            1, (lengths.long() - 1)[:, None, None].expand(b, 1, logits.shape[-1]))[:, 0]
        first = torch.argmax(last_logits, dim=-1).to(torch.int32)
        # disown the right-padding junk in both caches
        return _rollback(caches_t, lengths), _rollback(caches_d, lengths), first

    # -- host loop -------------------------------------------------------------

    def generate(self, prompts: Sequence[Sequence[int]], *, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None,
                 max_seq: Optional[int] = None) -> List[List[int]]:
        """Greedy speculative generation; one token list per prompt. The
        output is the target's greedy decoding (acceptance sets the speed,
        not the content); stats land in ``self.stats``."""
        b = len(prompts)
        if b == 0:
            return []
        lens = np.array([len(p) for p in prompts], np.int32)
        if lens.min() < 1:
            raise ValueError("prompts must be non-empty")
        t_max = int(lens.max())
        g = self.gamma
        needed = t_max + max_new_tokens + g + 2
        if max_seq is None:
            max_seq = needed
        elif max_seq < needed:
            raise ValueError(
                f"max_seq={max_seq} < prompt+max_new+gamma+2={needed}; speculative rounds "
                "write up to gamma+1 positions past the accepted length"
            )
        max_seq = ((max_seq + 1) // 2) * 2  # pair-packed caches need an even size

        device = self.target.device
        with torch.no_grad():
            caches_t = self.target.init_cache(self.cfg_t, b, max_seq)
            caches_d = self.draft.init_cache(self.cfg_d, b, max_seq)
            tokens = np.zeros((b, t_max), np.int32)
            for i, p in enumerate(prompts):
                tokens[i, :lens[i]] = p
            caches_t, caches_d, first = self._prefill(
                self.target, self.draft, caches_t, caches_d,
                torch.from_numpy(tokens).to(device), torch.from_numpy(lens).to(device))
            first = first.cpu().numpy()

            out: List[List[int]] = [[int(first[i])] for i in range(b)]
            done = np.array([out[i][0] == eos_id or max_new_tokens <= 1 for i in range(b)])
            last = np.array(first, np.int32)
            pos = lens.copy()  # position of `last` (its K/V not yet written)
            self.stats = SpecStats()

            while not done.all():
                pos_t = torch.from_numpy(pos).to(device)
                _rollback(caches_d, pos_t)
                _rollback(caches_t, pos_t)
                last_t = torch.from_numpy(last).to(device)
                caches_d, d_toks = self._draft_round(self.draft, caches_d, last_t, pos_t)
                caches_t, n, emitted, _, _ = self._verify(self.target, caches_t, last_t,
                                                          d_toks, pos_t)
                host = torch.cat([d_toks, n[:, None].to(torch.int32),
                                  emitted[:, None]], dim=1).cpu().numpy()
                d_np, n_np, e_np = host[:, :g], host[:, g], host[:, g + 1]
                self.stats.rounds += 1
                for i in range(b):
                    if done[i]:
                        continue
                    self.stats.drafted += g
                    self.stats.accepted += int(n_np[i])
                    for tok in [int(x) for x in d_np[i, :n_np[i]]] + [int(e_np[i])]:
                        out[i].append(tok)
                        if tok == eos_id or len(out[i]) >= max_new_tokens:
                            done[i] = True
                            break
                    # advance by the tokens KEPT (EOS may keep fewer than n+1)
                    last[i] = out[i][-1]
                    pos[i] = lens[i] + len(out[i]) - 1
        return out


def speculative_generate(target, draft, cfg_target, cfg_draft, prompts, *, gamma: int = 4,
                         max_new_tokens: int = 32, eos_id=None):
    """One-call greedy speculative decoding (see :class:`SpeculativeDecoder`);
    returns (token lists, :class:`SpecStats`)."""
    dec = SpeculativeDecoder(target, draft, cfg_target, cfg_draft, gamma=gamma)
    out = dec.generate(prompts, max_new_tokens=max_new_tokens, eos_id=eos_id)
    return out, dec.stats
