"""A layer span's device time with its children's, from the program's
span maps (``spans`` gives each span's own operations alone).

A span's operations are the graph nodes it enqueued itself or through a
span opened inside it: the ``moe.shared`` span's are the shared expert's
SwiGLU and its three ``linear`` children's kernels. A span map lists each
span after its parent (``SpanMap.spans``: name, parent index), so one pass
finds every span under a name.
"""
from __future__ import annotations

from typing import Optional

from . import spans


def total_ms_per_step(obs, name: str) -> Optional[float]:
    """Device ms a step of every graph node that span ``name`` or a span
    inside it enqueued, over the traced replays; None without a matching
    map or traced steps."""
    found = spans.labelled(obs.trace)
    if found is None or obs.steps_traced <= 0:
        return None
    span_map, reps = found
    inside = set()
    for i, (n, parent) in enumerate(span_map.spans):
        if n == name or parent in inside:
            inside.add(i)
    total = 0.0
    for ops in reps:
        for start, end, index in span_map.runs:
            if index in inside:
                total += sum(o.dur for o in ops[start:end]) / 1e3
    return total / obs.steps_traced


def roofline(obs, work: str, name: str) -> Optional[float]:
    """``obs.work[work]``'s least time over span ``name``'s device time with
    its children's, a step, as a percentage; None where it holds no time."""
    if obs.driver != "decode" or obs.work is None or work not in obs.work:
        return None
    ms = total_ms_per_step(obs, name)
    return 100.0 * obs.work[work].bound_s() * 1e3 / ms if ms else None
