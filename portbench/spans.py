"""The program's layer spans laid over a traced run's device operations.

The port records, while it captures a CUDA graph, which layer span
enqueued each node of the graph (``fused4bit_tpu_torch.utils.profiling``:
``span_maps()``, ``replay_span_ms``). A replay runs no Python, so the
profiler sees only the replay's kernels, memcpys and memsets; here they are
cut into replays and each replay is labelled through the map.

Cutting is exact, not a guess: the host launched every device operation of
the traced window, in one stream's order, by a runtime call the trace
records. Each ``cudaGraphLaunch`` accounts for as many operations as the
map has nodes, every other launch call (a kernel, a memcpy, a memset: the
token fetch, a replay's prologue) for one. When the trace's operations do
not number what its launch calls account for, nothing is returned. A
program without span maps (one older than its layer spans) gives nothing
either, and raises nothing.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .trace import DeviceOp, Trace

GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
ONE_OP_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
                   "cuMemset")


def program_maps() -> list:
    """The program's span maps, newest first; empty when it keeps none."""
    try:
        from fused4bit_tpu_torch.utils.profiling import span_maps
    except ImportError:
        return []
    return span_maps()


def _launches(tr: Trace) -> List[bool]:
    """The window's launch calls on the host, in order: True for a graph
    launch."""
    lo, hi = tr.window
    return [name.startswith(GRAPH_LAUNCHES) for s, _, name in tr.host
            if lo <= s <= hi and name.startswith(GRAPH_LAUNCHES + ONE_OP_LAUNCHES)]


def replays(tr: Trace, nodes: int) -> Optional[List[List[DeviceOp]]]:
    """Each graph launch's device operations, for a graph of ``nodes``
    nodes; None when the launch calls do not account for the operations."""
    launches = _launches(tr)
    graphs = sum(launches)
    if not graphs or nodes <= 0 or len(tr.ops) != len(launches) - graphs + graphs * nodes:
        return None
    out, i = [], 0
    for graph in launches:
        if graph:
            out.append(tr.ops[i:i + nodes])
            i += nodes
        else:
            i += 1
    return out


def labelled(tr: Optional[Trace]):
    """(map, the replays' ops) for the newest span map that the trace's
    graph launches match; None when none does."""
    if tr is None:
        return None
    for span_map in program_maps():
        reps = replays(tr, span_map.nodes)
        if reps is not None:
            return span_map, reps
    return None


def ms_per_step(tr: Optional[Trace], steps: int) -> Optional[Dict[str, float]]:
    """Device ms a step by span name (each span's own operations), and under
    ``""`` every graph operation's, over the traced replays of ``steps``
    steps in all; None without a matching map."""
    found = labelled(tr)
    if found is None or steps <= 0:
        return None
    from fused4bit_tpu_torch.utils.profiling import replay_span_ms

    span_map, reps = found
    total: Dict[str, float] = {"": 0.0}
    for ops in reps:
        for name, ms in replay_span_ms([(o.name, o.dur) for o in ops], span_map).items():
            total[name] = total.get(name, 0.0) + ms
            total[""] += ms
    return {name: ms / steps for name, ms in total.items()}


def share(obs, names: Sequence[str]) -> Optional[float]:
    """The spans' own device time as a percentage of the graph's, a step."""
    if obs.driver != "decode":
        return None
    ms = ms_per_step(obs.trace, obs.steps_traced)
    if ms is None or not ms[""]:
        return None
    return 100.0 * sum(ms.get(n, 0.0) for n in names) / ms[""]


def roofline(obs, work: str, names: Sequence[str]) -> Optional[float]:
    """``obs.work[work]``'s least time over the spans' own device time, a
    step, as a percentage; None where the spans hold no time."""
    if obs.driver != "decode" or obs.work is None or work not in obs.work:
        return None
    ms = ms_per_step(obs.trace, obs.steps_traced)
    if ms is None:
        return None
    spent = sum(ms.get(n, 0.0) for n in names)
    return 100.0 * obs.work[work].bound_s() * 1e3 / spent if spent else None
