"""Port vs JAX package: the measurement utilities (``utils.roofline``,
``utils.profiling``, ``utils.device_profile``, ``utils.benchmark``) and the
top-level exports.

The roofline equals JAX's on a shared chip exactly (integers) or to 1e-12
relative (floats); trace parsing is checked on a synthetic trace in the
layout ``torch.profiler`` exports for a CUDA run (kernel and
gpu_user_annotation events, ``dur`` in µs) and on a real CPU-only trace,
which must raise; the timers run on CPU tensors (no card here)."""
import gzip
import json
import math
import os

import numpy as np
import pytest
import torch

import fused4bit_tpu
import fused4bit_tpu_torch
from fused4bit_tpu.utils import roofline as jax_roofline
from fused4bit_tpu_torch.utils import (
    H100_SXM,
    BenchmarkResult,
    ChipSpec,
    annotate,
    device_op_times,
    linear_roofline,
    print_table,
    time_chain_slope,
    time_fn,
    time_fn_scan,
    time_fn_slope,
    trace,
)
from fused4bit_tpu_torch.utils.device_profile import _parse_trace


def test_top_level_exports_cover_jax():
    missing = [n for n in fused4bit_tpu.__all__ if not hasattr(fused4bit_tpu_torch, n)]
    assert missing == []
    for name in ("QuantizedDense", "FP4Tensor", "quantize_fp4", "elastic_loop",
                 "linear_roofline", "H100_SXM", "native", "utils"):
        assert name in fused4bit_tpu_torch.__all__
        assert hasattr(fused4bit_tpu_torch, name)


# --- roofline --------------------------------------------------------------------


@pytest.mark.parametrize("batch,k,n,kw", [
    (1, 4096, 11008, {}), (8192, 4096, 11008, {}), (8, 4096, 4096, dict(measured_s=20e-6)),
    (8, 4096, 14336, dict(weight_bits=8.0, act_bytes=4, measured_hbm_gbps=2900.0)),
])
def test_linear_roofline_matches_jax(batch, k, n, kw):
    chip = ChipSpec(name="shared", hbm_gbps=1000.0, bf16_tflops=200.0, f32_tflops=20.0,
                    int8_tops=400.0)
    jchip = jax_roofline.ChipSpec(name="shared", hbm_gbps=1000.0, bf16_tflops=200.0)
    got = linear_roofline(batch, k, n, chip=chip, **kw)
    want = jax_roofline.linear_roofline(batch, k, n, chip=jchip, **kw)
    assert (got.bytes_moved, got.flops, got.bound) == (want.bytes_moved, want.flops, want.bound)
    for f in ("arithmetic_intensity", "ridge_intensity", "sol_latency_us", "achieved_gbps",
              "achieved_tflops", "pct_of_sol"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None and b is None) or math.isclose(a, b, rel_tol=1e-12), f
    assert got.pretty() == want.pretty()


def test_h100_defaults():
    rep = linear_roofline(8, 4096, 4096)
    byte_s = (8 * 4096 * 2 + 4096 * 2048 + 8 * 4096 + 8 * 4096 * 2) / 3350e9
    assert rep.bound == "memory" and math.isclose(rep.sol_latency_us, byte_s * 1e6)
    assert H100_SXM.peak_ops("bf16") == 989e12 and H100_SXM.peak_ops("f32") == 67e12
    assert H100_SXM.peak_ops("int8") == 1979e12
    assert linear_roofline(8192, 4096, 11008).bound == "compute"


# --- traces ----------------------------------------------------------------------


# K1's kernel as the profiler names it on the H100 (mangled: it lives in an
# anonymous namespace)
K1 = ("_ZN3f4b47_GLOBAL__N__99fcb63d_14_int4_matmul_cu_cb3e9b2715int4_mma_kernelINS0_8RowScale"
      "ELi2ELb0EEEvNS0_7MmaArgsE")


def _kineto_trace(path, gz=False):
    """A trace laid out as torch.profiler exports one of a CUDA run."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python3"}},
        {"ph": "X", "cat": "user_annotation", "name": "decode_step", "pid": 7, "tid": 7,
         "ts": 0.0, "dur": 900.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 7, "tid": 7, "ts": 1.0,
         "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 7, "tid": 7,
         "ts": 2.0, "dur": 5.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "decode_step", "pid": 0, "tid": 7,
         "ts": 100.0, "dur": 40.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "inner", "pid": 0, "tid": 7,
         "ts": 110.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": K1, "pid": 0, "tid": 7, "ts": 100.0, "dur": 17.5},
        {"ph": "X", "cat": "kernel", "name": K1, "pid": 0, "tid": 7, "ts": 120.0, "dur": 18.5},
        {"ph": "X", "cat": "kernel", "name": "void int4_attention_mma_kernel<128, "
         "ContiguousCache>(AttnArgs, int)", "pid": 0, "tid": 7, "ts": 139.0, "dur": 0.5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "pid": 0,
         "tid": 7, "ts": 139.5, "dur": 0.5},
    ]
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)


@pytest.mark.parametrize("gz", [False, True])
def test_parse_kineto_trace(tmp_path, gz):
    _kineto_trace(tmp_path / ("host_1.pt.trace.json" + (".gz" if gz else "")), gz)
    prof = _parse_trace(str(tmp_path))
    assert set(prof.by_op) == {K1, "void int4_attention_mma_kernel<128, ContiguousCache>"
                               "(AttnArgs, int)", "Memcpy DtoH (Device -> Pinned)"}
    assert prof.matching_count("int4_mma_kernelINS0_8RowScale") == 2
    assert prof.matching_ms("int4_mma_kernel") == pytest.approx(0.036)
    assert prof.by_op[K1].mean_ms == pytest.approx(0.018)
    assert prof.total_ms == pytest.approx(0.037)
    assert "aten::mm" not in prof.by_op and "cudaLaunchKernel" not in prof.by_op
    assert prof.main_module_ms() == pytest.approx(0.04)   # the outermost range
    assert prof.main_module_ms("inner") == pytest.approx(0.01)
    with pytest.raises(KeyError):
        prof.main_module_ms("absent")


def test_parse_raises_without_device_events(tmp_path):
    with pytest.raises(RuntimeError, match="no trace"):
        _parse_trace(str(tmp_path))
    with open(tmp_path / "h.pt.trace.json", "w") as f:
        json.dump({"traceEvents": [{"ph": "X", "cat": "cpu_op", "name": "aten::mm",
                                    "pid": 1, "tid": 1, "ts": 0.0, "dur": 3.0}]}, f)
    with pytest.raises(RuntimeError, match="no device event"):
        _parse_trace(str(tmp_path))


def test_cpu_run_traces_but_has_no_device_time(tmp_path):
    """A real torch.profiler trace of CPU work: written under log_dir, with
    the annotation on the host timeline, and device_op_times raises."""
    with trace(str(tmp_path / "t")):
        with annotate("region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    (name,) = os.listdir(tmp_path / "t")
    assert name.endswith(".pt.trace.json")
    with open(tmp_path / "t" / name) as f:
        cats = {(e.get("cat"), e.get("name")) for e in json.load(f)["traceEvents"]}
    assert ("user_annotation", "region") in cats
    with pytest.raises(RuntimeError, match="no device event"):
        device_op_times(lambda: torch.ones(4) + 1, trace_dir=str(tmp_path / "d"))


# --- timers and tables -----------------------------------------------------------


def test_stopwatch_and_table(capsys):
    rows = [BenchmarkResult("base", 2.0, num_tokens=100), BenchmarkResult("fast", 1.0,
                                                                          num_tokens=100)]
    out = print_table(rows, baseline="base")
    assert "2.00x" in out and "1.00x" in out and capsys.readouterr().out.count("base") == 1
    assert rows[1].tokens_per_second == pytest.approx(100 / 1e-3)
    assert BenchmarkResult("none", 0.0).tokens_per_second == 0.0


def test_timers_on_cpu_tensors(rng):
    x = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))
    calls = []

    def f(v, m):
        calls.append(v.clone())
        return v @ m

    assert time_fn(lambda: x @ w, warmup=1, iters=3) > 0
    assert time_fn_scan(f, x, consts=(w,), iters=4, warmup=1, repeats=2) > 0
    # 4 chained applications per run, 1 warm-up and 2 repeats; each input is
    # sin(x + carry) of the previous output's carry, the first carry 0
    assert len(calls) == 12
    assert torch.equal(calls[0], torch.sin(x))
    assert not torch.equal(calls[1], calls[0])
    assert torch.equal(calls[8], torch.sin(x + 2))   # the second repeat's fresh input
    xi = torch.arange(16, dtype=torch.int32)
    assert time_fn_scan(lambda v: v * 3, xi, iters=3, warmup=1, repeats=1) > 0
    assert time_fn_slope(lambda v: v @ w, x, iters=2, repeats=1, chain=2) > 0
    sets = [torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32)) for _ in range(3)]
    assert time_chain_slope(lambda y, m: y @ m, x, sets, iters=2, repeats=1) > 0
    with pytest.raises(ValueError):
        time_chain_slope(lambda y, m: y @ m, x, sets, p_large=4)
