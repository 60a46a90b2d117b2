"""The port's layer spans (``utils.profiling.span``): innermost attribution
and parent links in a capture's span map (a fake node counter stands in for
the capturing graph), the shared no-op outside a recording entry, the
``f4b.*`` profiler ranges around their own aten ops in one CPU step of the
tiny model, the whole step labelled op by op, and ``replay_span_ms`` on
synthetic replays."""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fused4bit_tpu_torch.bench import decode_loop
from fused4bit_tpu_torch.models import QuantizedTransformer, flagship_model_config
from fused4bit_tpu_torch.ops.int4_matmul import int4_matmul
from fused4bit_tpu_torch.utils import profiling
from fused4bit_tpu_torch.utils.profiling import (
    KEEP_MAPS,
    UNLABELLED,
    SpanMap,
    entry,
    replay_span_ms,
    span,
    span_maps,
)

LAYER_SPANS = ("embed", "norm", "residual", "linear", "attention.rope", "attention.kv_append",
               "attention.kernel", "moe.route", "experts", "moe.swiglu", "moe.combine", "sample")


class _FakeCapture:
    """A capturing graph that gains nodes when the test says so."""

    def __init__(self, capture_id: int):
        self.id, self.nodes = capture_id, 0

    def add(self, n: int) -> None:
        self.nodes += n

    def probe(self):
        return self.id, lambda: self.nodes


@pytest.fixture
def capture(monkeypatch):
    monkeypatch.setattr(profiling, "_MAPS", type(profiling._MAPS)())
    fake = _FakeCapture(7)
    monkeypatch.setattr(profiling, "capture_probe", fake.probe)
    return fake


def test_innermost_attribution_and_parents(capture):
    with entry():
        capture.add(2)                          # outside every span
        with span("a"):
            capture.add(1)
            with span("b"):
                capture.add(3)
                with entry():                   # a nested entry changes nothing
                    with span("c"):
                        capture.add(1)
            capture.add(1)
        with span("b"):                         # the same name at the top: its own span
            capture.add(2)
    capture.add(1)                              # between entries: outside every span
    with entry(), span("a"):
        capture.add(1)
    (m,) = span_maps()
    assert m.capture_id == 7 and m.nodes == 12
    assert m.spans == [("a", -1), ("b", 0), ("c", 1), ("b", -1)]
    assert m.labels() == [UNLABELLED] * 2 + ["a"] + ["b"] * 3 + ["c", "a", "b", "b",
                                                                  UNLABELLED, "a"]
    assert m.runs == [(0, 2, -1), (2, 3, 0), (3, 6, 1), (6, 7, 2), (7, 8, 0), (8, 10, 3),
                      (10, 11, -1), (11, 12, 0)]
    ops = [(f"k{i}", 1000.0 * (i + 1)) for i in range(12)]      # node i takes i+1 ms
    assert replay_span_ms(ops, m) == {UNLABELLED: 1 + 2 + 11, "a": 3 + 8 + 12,
                                      "b": 4 + 5 + 6 + 9 + 10, "c": 7}


def test_a_broken_chain_matches_no_replay(capture):
    """A counter that loses the chain (another stream joined the capture)
    leaves a map that no replay's operations match."""
    with entry(), span("a"):
        capture.add(2)
    capture.nodes = -1
    with entry(), span("a"):
        pass
    (m,) = span_maps()
    assert m.broken and m.nodes == -1
    with pytest.raises(ValueError, match="-1 nodes"):
        replay_span_ms([("k", 1.0)] * 2, m)


def test_newest_maps_are_kept(capture):
    for cid in range(1, KEEP_MAPS + 4):
        capture.id = cid
        with entry(), span("a"):
            capture.add(1)
    assert [m.capture_id for m in span_maps()] == list(range(KEEP_MAPS + 3, 3, -1))


def test_no_op_outside_capture_and_profiler(monkeypatch):
    monkeypatch.setattr(profiling, "_MAPS", type(profiling._MAPS)())
    first = span("a")
    with entry():
        inner = span("b")
        with inner:
            pass
    assert first is inner is span("c") and profiling._active is None
    assert span_maps() == []


def _tiny():
    cfg = flagship_model_config("tiny")
    gen = torch.Generator().manual_seed(0)
    model = QuantizedTransformer.init(cfg, generator=gen, device="cpu")
    caches = model.init_cache(cfg, 2, 16)
    tok0 = torch.tensor([[3], [5]], dtype=torch.int32)
    pos0 = torch.tensor([[2], [4]], dtype=torch.int32)
    return model, caches, tok0, pos0


# aten ops and the span each must fall in
OWN_OPS = {"aten::embedding": "embed", "aten::rsqrt": "norm", "aten::cos": "attention.rope",
           "aten::topk": "moe.route", "aten::silu": "moe.swiglu", "aten::argmax": "sample"}


def test_profiler_ranges_hold_their_own_ops():
    model, caches, tok0, pos0 = _tiny()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        decode_loop(model, caches, tok0, pos0, 1)
    events = [e for e in prof.events() if e.time_range.elapsed_us() >= 0]
    ranges = [e for e in events if e.name.startswith(profiling.PREFIX)]
    assert {e.name[len(profiling.PREFIX):] for e in ranges} == set(LAYER_SPANS)

    def innermost(op):
        around = [r for r in ranges if r.thread == op.thread
                  and r.time_range.start <= op.time_range.start
                  and op.time_range.end <= r.time_range.end]
        return max(around, key=lambda r: r.time_range.start).name if around else None

    aten = [e for e in events if e.name.startswith("aten::")]
    for op in aten:
        if op.name in OWN_OPS:
            assert innermost(op) == profiling.PREFIX + OWN_OPS[op.name], op.name
    for r in ranges:                       # every range is around some aten op of its own
        assert any(innermost(op) == r.name and r.time_range.start <= op.time_range.start
                   and op.time_range.end <= r.time_range.end for op in aten), r.name


class _OpsAsNodes(TorchDispatchMode):
    """Every aten op a node of the fake capturing graph, named by its op."""

    def __init__(self, capture):
        super().__init__()
        self.capture, self.names = capture, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        self.capture.add(1)
        return func(*args, **(kwargs or {}))


def test_a_step_is_labelled_op_by_op(capture, monkeypatch):
    """Two decode steps "captured" op by op: every op inside a span, each
    op where its layer put it, the dense linears inside ``linear``."""
    model, caches, tok0, pos0 = _tiny()
    monkeypatch.setitem(int4_matmul.__kwdefaults__, "prefill_threshold", 1)
    with _OpsAsNodes(capture) as mode:
        decode_loop(model, caches, tok0, pos0, 2)
    (m,) = span_maps()
    labels = m.labels()
    assert len(labels) == len(mode.names) == m.nodes > 0
    assert UNLABELLED not in labels
    assert set(labels) == set(LAYER_SPANS) | {"linear.dense"}
    parents = {name: {m.spans[i][0] if i >= 0 else None for n, i in m.spans if n == name}
               for name, _ in m.spans}
    assert parents["linear"] == {None, "moe.route"}         # projections, lm_head; the router
    assert parents["linear.dense"] == {"linear"}
    assert parents["experts"] == {None}
    for name, label in zip(mode.names, labels):
        if name in ("aten.topk", "aten.argmax", "aten.embedding", "aten.silu", "aten.cos"):
            assert label == OWN_OPS[name.replace(".", "::")], name
    ops = [(n, 1.0) for n in mode.names] + [("Memcpy DtoH (Device -> Pageable)", 5.0)]
    ms = replay_span_ms(ops, m)
    assert sum(ms.values()) == pytest.approx(len(mode.names) / 1e3)


def test_replay_span_ms_checks_the_count():
    m = SpanMap(3, spans=[("a", -1), ("b", 0)], runs=[(0, 2, 0), (2, 3, 1)])
    ops = [("k", 10.0), ("k", 20.0), ("memcpy DtoD", 30.0)]
    assert replay_span_ms(ops, m) == {"a": 0.03, "b": 0.03}
    fetch = ("Memcpy DtoH (Device -> Pageable)", 99.0)
    assert replay_span_ms(ops + [fetch], m) == {"a": 0.03, "b": 0.03}    # the fetch is left out
    with pytest.raises(ValueError, match="3 nodes"):
        replay_span_ms(ops[:2], m)
    with pytest.raises(ValueError, match="3 nodes"):
        replay_span_ms(ops + [("k", 1.0)], m)                  # one more, not a fetch
    with pytest.raises(ValueError, match="3 nodes"):
        replay_span_ms(ops + [fetch, fetch], m)
