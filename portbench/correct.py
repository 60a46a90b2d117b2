"""The comparison that decides ``correct``.

A served token is judged by the reference's logits at the position that
produced it: its gap is the reference's best logit there minus the
reference's logit of the served token (0 when the program chose the
reference's own best). A routing decision is judged by the margin of the
chosen experts below the reference's own top-k (``reference.Job``). The
mean of each over the compared tokens, and the largest mean gap of one
sequence, are held to the cell's limits (``limits/<cell>.json``): with
random weights the widest gap of one token swings from seed to seed by
more than the control departs (PERF.md), the means do not. Greedy serving only: a token sampled at a temperature is not judged
this way.
"""
from __future__ import annotations

from typing import Dict

import torch


def token_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """ref_logits [..., V] (float32), tokens [...] -> the gap of each token."""
    ref_logits = ref_logits.float()
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tokens.to(ref_logits.device).long()[..., None])[..., 0]
    return best - got


def compared(gaps: torch.Tensor, route_gap: float) -> Dict[str, float]:
    """The compared numbers of one run, from the gaps [sequences, tokens] of
    the compared tokens: their mean; the largest mean of one sequence's
    tokens, so that a fault confined to one sequence is not diluted by the
    batch; and the mean margin of the routing decisions."""
    if not gaps.numel():
        return {"mean_logit_gap": float("inf"), "worst_seq_logit_gap": float("inf"),
                "mean_route_gap": route_gap}
    g = gaps.float()
    return {"mean_logit_gap": float(g.mean()), "worst_seq_logit_gap": float(g.mean(dim=1).max()),
            "mean_route_gap": route_gap}


def gap_stats(gaps: torch.Tensor) -> Dict[str, float]:
    """Summaries of the compared tokens' gaps (the calibration prints them
    all; ``mean`` is the compared one)."""
    g = gaps.float().flatten()
    return {"max": float(g.max()), "mean": float(g.mean()),
            "p99": float(torch.quantile(g, 0.99)), "not_best_share": float((g > 0).float().mean()),
            "n": int(g.numel())}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit; a number passes at or under
    its limit."""
    out = {}
    for name, value in values.items():
        limit = limits[name]
        out[name] = {"value": value, "limit": limit, "ok": value <= limit}
    return out


def all_ok(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(c["ok"] for c in checks.values())


def stderr_lines(checks: Dict[str, dict]) -> str:
    return "\n".join(f"check {name}: {c['value']!r} (limit {c['limit']!r}) "
                     f"{'ok' if c['ok'] else 'FAILED'}" for name, c in checks.items())


def result_checks(checks: Dict[str, dict]) -> Dict[str, dict]:
    return {name: {"value": c["value"], "limit": c["limit"]} for name, c in checks.items()}

