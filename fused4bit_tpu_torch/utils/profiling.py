"""Profiling and tracing hooks, and the program's layer spans.

Counterpart of ``fused4bit_tpu/utils/profiling.py``: :func:`trace` records
a ``torch.profiler`` trace (host ops, and the card's kernels where a CUDA
device exists) and exports it as a Chrome trace into ``log_dir``;
:func:`annotate` names a region (``torch.profiler.record_function``), which
also appears on the card's timeline around the kernels it launched.

Layer spans. :func:`span` names the layer of the program that enqueues the
device operations inside it (``linear``, ``experts``, ``moe.route``, ...).
What a span does is settled once per top-level :func:`entry` (a model's
forward, a step of ``bench.decode_loop``), from the state of the card:

* while the current CUDA stream captures a graph, each span reads the
  capturing graph's node count at its entry and exit (``csrc/capture.cu``),
  and the runs of nodes each innermost span added go into that capture's
  :class:`SpanMap` (:func:`span_maps`, the newest :data:`KEEP_MAPS`). A
  replay runs no Python, so the spans cost nothing there; the map labels
  the replay's device operations after the fact (:func:`replay_span_ms`);
* while ``torch.profiler`` records, each span is a ``record_function``
  range named ``f4b.<name>``, which the profiler links to its kernels;
* otherwise every span is one shared no-op context.

A device operation belongs to the innermost span open when it was
enqueued; a span's total is its own operations' time and its children's.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import os
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import torch

__all__ = ["trace", "annotate", "span", "entry", "SpanMap", "span_maps", "replay_span_ms",
           "PREFIX", "UNLABELLED", "KEEP_MAPS"]

PREFIX = "f4b."                 # the profiler ranges' prefix
UNLABELLED = "unlabelled"       # nodes a capture added outside every span
KEEP_MAPS = 8                   # span maps kept, newest last


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Record a profiler trace of the block into ``log_dir`` as a Chrome
    trace (``<pid>_<ns>.pt.trace.json``; open with Perfetto or TensorBoard).
    The card is synchronized before the trace stops."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)


# -- layer spans ------------------------------------------------------------------


@dataclasses.dataclass
class SpanMap:
    """The layer spans of one CUDA graph capture.

    ``spans``: each distinct span, as (name, index of its parent in
    ``spans``, or -1 at the top); ``runs``: (first node, end node, index in
    ``spans``, or -1 outside every span), in node order, covering nodes 0 to
    :attr:`nodes` of the graph without a gap. ``broken``: the capture's
    nodes stopped being one chain (another stream joined it), so their order
    at a replay is not the capture's; the map then matches no replay."""

    capture_id: int
    spans: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    runs: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)
    broken: bool = False
    _ids: Dict[Tuple[str, int], int] = dataclasses.field(default_factory=dict, repr=False,
                                                         compare=False)

    @property
    def nodes(self) -> int:
        """The graph's nodes the map labels; -1 when it is broken."""
        if self.broken:
            return -1
        return self.runs[-1][1] if self.runs else 0

    def name(self, index: int) -> str:
        """The name of span ``index``; :data:`UNLABELLED` for -1."""
        return self.spans[index][0] if index >= 0 else UNLABELLED

    def labels(self) -> List[str]:
        """The innermost span's name of every node, in node order."""
        return [self.name(i) for s, e, i in self.runs for _ in range(s, e)]

    def _index(self, parent: int, name: str) -> int:
        key = (name, parent)
        if key not in self._ids:
            self._ids[key] = len(self.spans)
            self.spans.append(key)
        return self._ids[key]

    def _add(self, start: int, end: int, index: int) -> None:
        if end <= start:
            return
        if self.runs and self.runs[-1][2] == index and self.runs[-1][1] == start:
            self.runs[-1] = (self.runs[-1][0], end, index)
        else:
            self.runs.append((start, end, index))


_MAPS: "collections.OrderedDict[int, SpanMap]" = collections.OrderedDict()
_NOOP = contextlib.nullcontext()
_active = None                  # the recorder of the open top-level entry, or None


def span_maps() -> List[SpanMap]:
    """The span maps of the newest captures, newest first."""
    return list(reversed(_MAPS.values()))


def span(name: str):
    """The layer span ``name`` around the operations enqueued inside it (the
    module docstring); the shared no-op context outside a recording entry."""
    rec = _active
    return _NOOP if rec is None else rec.span(name)


class _NodeSpan:
    __slots__ = ("rec", "name")

    def __init__(self, rec: "_CaptureRecorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        rec.close_run()
        rec.stack.append(rec.map._index(rec.stack[-1], self.name))

    def __exit__(self, *exc):
        self.rec.close_run()
        self.rec.stack.pop()
        return False


class _CaptureRecorder:
    """Labels the nodes one entry adds to a capturing graph."""

    def __init__(self, capture_id: int, count: Callable[[], int]):
        span_map = _MAPS.get(capture_id)
        if span_map is None:
            span_map = _MAPS[capture_id] = SpanMap(capture_id)
            while len(_MAPS) > KEEP_MAPS:
                _MAPS.popitem(last=False)
        self.map, self.count, self.stack = span_map, count, [-1]
        self.last = span_map.runs[-1][1] if span_map.runs else 0
        self.close_run()            # nodes added between entries: outside every span

    def close_run(self) -> None:
        n = self.count()
        if n < 0:
            self.map.broken = True
        self.map._add(self.last, n, self.stack[-1])
        self.last = n

    def span(self, name: str) -> _NodeSpan:
        return _NodeSpan(self, name)

    def close(self) -> None:
        self.close_run()


class _ProfileRecorder:
    @staticmethod
    def span(name: str):
        return annotate(PREFIX + name)

    def close(self) -> None:
        pass


_PROFILER = _ProfileRecorder()


_CHAINS: "collections.OrderedDict[int, list]" = collections.OrderedDict()


def _cuda_capture() -> Optional[Tuple[int, Callable[[], int]]]:
    """The id of the graph the current CUDA stream captures and a counter of
    its nodes (``f4b_capture_nodes_since``: -1 once they are not one chain);
    None when no capture runs. The counter goes on from where the capture's
    previous entry left it, so each node is walked once."""
    if not torch.cuda.is_initialized() or not torch.cuda.is_current_stream_capturing():
        return None
    from ..ops import _build

    fn = _build.library().f4b_capture_nodes_since
    stream = torch.cuda.current_stream().cuda_stream
    cid, last, added = ctypes.c_ulonglong(), ctypes.c_void_p(), ctypes.c_longlong()
    _build.check(fn(stream, None, ctypes.byref(cid), ctypes.byref(last), None),
                 "f4b_capture_nodes_since")
    chain = _CHAINS.get(cid.value)      # [the newest node counted, nodes counted]
    if chain is None:
        chain = _CHAINS[cid.value] = [None, 0]
        while len(_CHAINS) > KEEP_MAPS:
            _CHAINS.popitem(last=False)
    since = ctypes.c_void_p(chain[0])
    out = (ctypes.byref(cid), ctypes.byref(since), ctypes.byref(added))

    def count() -> int:
        if chain[1] >= 0:
            err = fn(stream, since, *out)
            if err:
                _build.check(err, "f4b_capture_nodes_since")
            chain[0] = since.value
            chain[1] = chain[1] + added.value if added.value >= 0 else -1
        return chain[1]

    return cid.value, count


# Where a top-level entry looks for a capture; tests put a fake counter here.
capture_probe: Callable[[], Optional[Tuple[int, Callable[[], int]]]] = _cuda_capture


@contextlib.contextmanager
def entry() -> Iterator[None]:
    """A top-level entry of the program: settles, once, what the spans
    inside it do (the module docstring). Nested entries change nothing."""
    global _active
    if _active is not None:
        yield
        return
    probe = capture_probe()
    if probe is not None:
        rec = _CaptureRecorder(*probe)
    elif torch.autograd._profiler_enabled():
        rec = _PROFILER
    else:
        yield
        return
    _active = rec
    try:
        yield
    finally:
        _active = None
        rec.close()


def replay_span_ms(ops: Iterable[Tuple[str, float]], span_map: SpanMap) -> Dict[str, float]:
    """Device ms by span of one replay of the graph ``span_map`` describes.

    ``ops``: the replay's device operations in start order, as (name,
    duration in microseconds) pairs, as a Chrome trace of ``torch.profiler``
    gives them (kernels, memcpys and memsets); a trailing device-to-host
    copy beyond the map's nodes (the replay's token fetch) is left out.
    A replay of a graph captured from one stream runs its nodes in capture
    order, so the i-th operation is the i-th node. Returns each span's own
    operations' ms (a parent's total adds its children's, ``span_map.spans``
    links them), and :data:`UNLABELLED`'s for nodes outside every span. Raises
    ``ValueError`` when the operations do not number the map's nodes."""
    ops = list(ops)
    n = span_map.nodes
    if len(ops) == n + 1 and "DtoH" in ops[-1][0]:          # "Memcpy DtoH (...)"
        ops = ops[:-1]
    if len(ops) != n:
        raise ValueError(f"{len(ops)} device operations for a graph of {n} nodes "
                         f"(capture {span_map.capture_id}): not one replay of it")
    out: Dict[str, float] = {}
    for start, end, index in span_map.runs:
        name = span_map.name(index)
        out[name] = out.get(name, 0.0) + sum(d for _, d in ops[start:end]) / 1e3
    return out
