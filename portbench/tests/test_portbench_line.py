"""The result line: exactly the contract's keys, ``checks`` last, and with a
trace the device's busy and window seconds and the breakdown; the trace's
reading (busy time, gaps, kernel families) on a synthetic profiler file."""
import json
import types

import torch

from portbench import harness, registry, trace
from portbench.roofline import Work
from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _chrome(tmp_path):
    """Two kernels of the port and one of torch's inside the range, a gap
    under a host op, and a kernel outside the range."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.RANGE, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 40, "dur": 30},
        {"ph": "X", "cat": "kernel", "ts": 10, "dur": 20,
         "name": "_ZN12_GLOBAL__N_115int4_mma_kernelINS_8RowScaleELi2ELb1EEEvT_"},
        {"ph": "X", "cat": "kernel", "ts": 30, "dur": 5,
         "name": "void (anonymous namespace)::int4_mma_reduce_kernel<X>(Y)"},
        {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise_kernel<128>(...)",
         "ts": 80, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 300, "dur": 10},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.parse(str(path))


def test_trace_reading(tmp_path):
    t = _chrome(tmp_path)
    assert len(t.ops) == 3 and t.window_s == 100e-6
    assert abs(t.busy_s - 35e-6) < 1e-12
    assert t.gaps() == [(0, 10), (35, 80), (90, 100)]
    assert t.host_at([5, 50, 95]) == ["host: between traced operations", "aten::copy_",
                                   "host: between traced operations"]
    grouped = trace.family_ms(t.kernels(), lambda n: trace.grouped_flag(n) is True)
    assert abs(grouped - 0.025) < 1e-12           # main kernel and its second pass
    b = t.breakdown()
    assert b["device_ops"][0][1] == 20e-6 and b["idle_gaps"][0] == ["aten::copy_", 45e-6]


def test_csrc_kernel_names():
    from portbench import program
    names = trace.csrc_kernels(program.csrc())
    assert {"int4_mma_kernel", "int4_attention_mma_kernel", "rows_used_kernel"} <= set(names)


def test_untraced_line_has_the_contract_keys(tmp_path):
    root, bench = tiny.make_root(tmp_path)
    line, stderr = tiny.run(root, bench, "tiny_decode")
    assert list(line) == KEYS[:5] + ["reference_s", "checks"]
    assert set(line["metrics"]) == {"decode_tok_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == {"mean_logit_gap", "worst_seq_logit_gap", "mean_route_gap",
                                   "replays_differing"}
    assert stderr.splitlines()[-1].startswith("check replays_differing")


def test_traced_line_has_breakdown_and_device_seconds(tmp_path, monkeypatch):
    root, bench = tiny.make_root(tmp_path)
    t = _chrome(tmp_path)
    from portbench import program
    obs = harness.Observations(driver="decode", trace=t,
                               own_kernels=trace.csrc_kernels(program.csrc()),
                               work={k: Work(1e6, 1e6) for k in
                                     ("int4_matmul", "grouped_matmul", "decode_attention",
                                      "step")},
                               steps_traced=1, device_ms_per_step=1.0)
    out = harness.Outcome(end_to_end={}, obs=obs, attempted=1, failed=0,
                          checks={"mean_logit_gap": 0.0, "worst_seq_logit_gap": 0.0,
                                  "mean_route_gap": 0.0, "replays_differing": 0},
                          memory_peak_bytes=1)
    monkeypatch.setattr(registry, "driver", lambda name: types.SimpleNamespace(run=lambda c: out))
    cell = registry.cell("tiny.tiny_decode", bench, root)
    ctx = harness.Context(cell=cell, spec=None, seed=1, seconds=1, trace=True,
                          device=torch.device("cpu"), t_start=0.0)
    line, _ = harness.run_cell(ctx, root)
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert line["device"]["busy_s"] == t.busy_s and line["device"]["window_s"] == t.window_s
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no linear or attention kernel in this trace: those readers find
    # nothing and their metrics are left out, never reported as 0
    assert set(line["metrics"]) == set(cell.per_layer) - {"int4_matmul_roofline",
                                                          "decode_attention_roofline"}
    assert abs(line["metrics"]["device_idle_pct.decode"]["value"] - 65.0) < 1e-9
    assert abs(line["metrics"]["model.glue_share.decode"]["value"] - 100 * 10 / 35) < 1e-9
