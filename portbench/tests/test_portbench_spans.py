"""The readers of the program's layer spans (``spans.py`` and the six
``*.span_roofline.decode`` / ``*.glue_share.decode`` / ``model.rest_share``
readers) on synthetic traces and span maps: replays cut by the host's launch
calls, each reader's value by hand, and every case where they must give
nothing. On a card, one test captures the `layer2` decode loop and checks
that two profiled replays line up with the capture's span map, node for
operation, and that every kernel the name rules place in a family falls in
that family's span:

    python3 -m pytest portbench/tests/test_portbench_spans.py -m chip -q
"""
import collections

import pytest
import torch

from fused4bit_tpu_torch.utils import profiling
from fused4bit_tpu_torch.utils.profiling import SpanMap
from portbench import harness, registry, spans, trace
from portbench.roofline import Work
from portbench.trace import DeviceOp, Trace

READERS = registry.metric_readers()
NEW = ("linear.span_roofline.decode", "experts.span_roofline.decode",
       "attention.span_roofline.decode", "moe.glue_share.decode",
       "attention.glue_share.decode", "model.rest_share.decode")

# one step of a toy graph: (span, device us) per node
STEP = [("embed", 1.0), ("norm", 2.0), ("linear", 10.0), ("attention.rope", 3.0),
        ("attention.kv_append", 4.0), ("attention.kernel", 20.0), ("linear", 10.0),
        ("residual", 1.0), ("norm", 2.0), ("moe.route", 5.0), ("linear", 2.0),
        ("linear.dense", 6.0), ("experts", 40.0), ("moe.swiglu", 3.0), ("experts", 20.0),
        ("moe.combine", 4.0), ("residual", 1.0), ("linear", 30.0), ("sample", 2.0)]
STEPS = 2


def _map(capture_id=11):
    """The toy graph's span map: two steps of ``STEP``; the router's linear
    inside ``moe.route``, ``linear.dense`` inside it."""
    m = SpanMap(capture_id)
    for _ in range(STEPS):
        for i, (name, _) in enumerate(STEP):
            parent = -1
            if name == "linear" and STEP[i - 1][0] == "moe.route":
                parent = m._index(-1, "moe.route")
            if name == "linear.dense":
                parent = m._index(m._index(-1, "moe.route"), "linear")
            m._add(m.nodes, m.nodes + 1, m._index(parent, name))
    return m


def _trace(replays=2, nodes=None, prologue=0):
    """``replays`` replays of the toy graph, each launched by one
    cudaGraphLaunch after ``prologue`` kernel launches and followed by the
    token fetch; times in us."""
    ops, host, t = [], [], 10.0
    per = [d for _, d in STEP] * STEPS if nodes is None else [1.0] * nodes
    for _ in range(replays):
        for _ in range(prologue):
            host.append((t, t + 1, "cudaLaunchKernel"))
            ops.append(DeviceOp("void copy_kernel", "kernel", t + 1, 0.5))
            t += 2
        host.append((t, t + 0.5, "cudaGraphLaunch"))
        for d in per:
            ops.append(DeviceOp("void some_kernel<1>", "kernel", t + 1, d))
            t += d + 0.1
        host.append((t, t + 3, "cudaMemcpyAsync"))
        ops.append(DeviceOp("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", t + 1, 2.0))
        host.append((t + 3, t + 4, "cudaStreamSynchronize"))
        t += 10
    host.sort()
    return Trace(ops, host, (0.0, t + 10))


def _obs(tr, driver="decode", work=True):
    bound = {"int4_matmul": 1e-6, "grouped_matmul": 3e-6, "decode_attention": 1e-6}
    return harness.Observations(
        driver=driver, trace=tr, steps_traced=2 * STEPS,
        work={k: Work(bytes=v * 3.35e12) for k, v in bound.items()} if work else None)


@pytest.fixture
def maps(monkeypatch):
    """The program's span maps, as the tests set them."""
    held = collections.OrderedDict()
    monkeypatch.setattr(profiling, "_MAPS", held)
    return held


def _own_ms(names):
    return sum(d for n, d in STEP if n in names) / 1e3     # a step


def test_every_new_metric_has_its_reader():
    assert set(NEW) <= set(READERS)
    per_layer = {m["name"]: m for m in registry.manifest()["per_layer"]}
    cells = [w["name"] for w in registry.manifest()["workloads"]]
    for name in NEW:
        assert per_layer[name]["workloads"] == cells
        assert (per_layer[name]["source"], per_layer[name]["moves"]) == ("device_trace",
                                                                         "decode_tok_s")


def test_readers_by_hand(maps):
    maps[11] = _map()
    obs = _obs(_trace())
    got = {name: READERS[name].read(obs) for name in NEW}
    total = _own_ms([n for n, _ in STEP])
    assert got["linear.span_roofline.decode"] == pytest.approx(
        100 * 1e-3 / _own_ms(["linear", "linear.dense"]))
    assert got["experts.span_roofline.decode"] == pytest.approx(100 * 3e-3 / _own_ms(["experts"]))
    assert got["attention.span_roofline.decode"] == pytest.approx(
        100 * 1e-3 / _own_ms(["attention.kernel"]))
    assert got["moe.glue_share.decode"] == pytest.approx(
        100 * _own_ms(["moe.route", "moe.swiglu", "moe.combine"]) / total)
    assert got["attention.glue_share.decode"] == pytest.approx(
        100 * _own_ms(["attention.rope", "attention.kv_append"]) / total)
    assert got["model.rest_share.decode"] == pytest.approx(
        100 * _own_ms(["embed", "norm", "residual", "sample"]) / total)


def test_replays_are_cut_by_the_launch_calls(maps):
    m = _map()
    nodes = m.nodes
    for replays, prologue in ((2, 0), (2, 2), (3, 1)):
        tr = _trace(replays, prologue=prologue)
        reps = spans.replays(tr, nodes)
        assert reps is not None and [len(r) for r in reps] == [nodes] * replays
        # the fetch and the prologue are nobody's nodes
        assert all(o.name == "void some_kernel<1>" for r in reps for o in r)
        assert len(tr.ops) == replays * (nodes + 1 + prologue)
    assert spans.replays(_trace(), nodes + 1) is None and spans.replays(_trace(), nodes - 1) is None
    maps[11] = m
    # the prologue changes no reading
    assert READERS["moe.glue_share.decode"].read(_obs(_trace(prologue=2))) == pytest.approx(
        READERS["moe.glue_share.decode"].read(_obs(_trace())))


def test_the_newest_matching_map_is_read(maps):
    maps[5] = SpanMap(5, spans=[("experts", -1)], runs=[(0, 3, 0)])    # another graph
    maps[11] = _map()
    assert spans.labelled(_trace())[0].capture_id == 11
    maps.move_to_end(5)                               # newest, but of another size
    assert spans.labelled(_trace())[0].capture_id == 11
    assert spans.labelled(_trace(nodes=3))[0].capture_id == 5


@pytest.mark.parametrize("case", ["no map", "other size", "broken", "no trace", "no work",
                                  "other driver", "program without spans", "no replay"])
def test_readers_give_nothing(maps, monkeypatch, case):
    maps[11] = _map()
    tr = _trace()
    obs = _obs(tr)
    if case == "no map":
        maps.clear()
    elif case == "other size":
        obs = _obs(_trace(nodes=len(STEP) * STEPS + 1))
    elif case == "broken":
        maps[11].broken = True
    elif case == "no trace":
        obs = _obs(None)
    elif case == "no work":
        obs = _obs(tr, work=False)
    elif case == "other driver":
        obs = _obs(tr, driver="serve")
    elif case == "program without spans":
        monkeypatch.delattr(profiling, "span_maps")
    elif case == "no replay":                   # an eager trace: no graph launch at all
        obs = _obs(Trace([o for o in tr.ops], [h for h in tr.host if h[2] != "cudaGraphLaunch"],
                         tr.window))
    got = {name: READERS[name].read(obs) for name in NEW}
    if case == "no work":                       # the shares need no work counts
        assert all(got[n] is None for n in NEW if "roofline" in n)
        assert all(got[n] is not None for n in NEW if "share" in n)
    else:
        assert got == dict.fromkeys(NEW)


@pytest.mark.chip
def test_layer2_replays_line_up_with_the_span_map():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spans label a CUDA graph's replays")
    from fused4bit_tpu_torch.bench import MAX_SEQ, CapturedLoop
    from fused4bit_tpu_torch.models import QuantizedTransformer, flagship_model_config

    cfg = flagship_model_config("layer2")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = QuantizedTransformer.init(cfg, generator=gen, device="cuda")
    loop = CapturedLoop(model, model.init_cache(cfg, 8, MAX_SEQ), 8)
    span_map = profiling.span_maps()[0]
    assert span_map.nodes > 0 and not span_map.broken

    def replay():
        loop.graph.replay()
        return loop.toks.cpu()

    tr = trace.record(lambda: [replay() for _ in range(2)])
    reps = spans.replays(tr, span_map.nodes)
    assert reps is not None and [len(r) for r in reps] == [span_map.nodes] * 2
    labels = span_map.labels()
    assert profiling.UNLABELLED not in labels
    placed = collections.Counter()
    for ops in reps:
        for op, label in zip(ops, labels):
            flag = trace.grouped_flag(op.name)
            family = ("experts" if flag is True else "linear" if flag is False
                      else "attention.kernel" if "int4_attention" in op.name else None)
            if family is not None:
                assert label == family, (op.name, label)
                placed[family] += 1
    assert set(placed) == {"experts", "linear", "attention.kernel"}
