"""The benchmark's files: every configuration, mix, limit and metric reader
loads and agrees with BENCHMARK.json; a new one is found by its name alone;
names, units and lengths keep the contract's characters; nothing a run
imports is JAX or the JAX package."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import registry
from portbench.inputs import ModelSpec

BENCH = registry.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden_size", "intermediate_size", "num_attention_heads", "num_key_value_heads",
          "num_experts_per_tok", "head_dim")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_resolves(w):
    cell = registry.cell(w["name"], BENCH)
    assert cell.config["name"] == w["config"] and cell.traffic["name"] == w["traffic"]
    assert cell.chips == 1
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2 and cell.per_layer
    spec = ModelSpec.from_config(cell.config)
    assert spec.heads * spec.head_dim == spec.hidden
    assert set(cell.limits) == {"mean_logit_gap", "worst_seq_logit_gap", "mean_route_gap",
                                "replays_differing"}


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_state_their_source_and_cut(c):
    cfg = json.loads((registry.REPO / c["file"]).read_text())
    assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    assert {"assumed", "deployment", "quantization", "cut"} <= set(cfg)
    assert not set(c["reduced"]) & set(WIDTHS)
    for key in c["reduced"]:
        assert key in cfg.get("published", {}), key


def test_readers_agree_with_the_manifest():
    """Every per-layer metric has its reader, which declares what the
    manifest says, and every reader its metric."""
    readers = registry.metric_readers()
    assert set(m["name"] for m in BENCH["per_layer"]) == set(readers)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        r = readers[m["name"]]
        assert (r.UNIT, r.BETTER, r.SOURCE, r.LAYER, r.MOVES) == (
            m["unit"], m["better"], m["source"], m["layer"], m["moves"])
        assert m["moves"] in e2e
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))


def test_names_units_and_lengths():
    items = BENCH["end_to_end"] + BENCH["per_layer"] + BENCH["workloads"] + BENCH["configs"]
    names = [i["name"] for i in items]
    assert len(names) == len(set(names))
    for i in items:
        assert NAME.match(i["name"]), i["name"]
        if "unit" in i:
            assert UNIT.match(i["unit"]), i["unit"]
            assert i["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in i:
                assert 1 <= len(i[key]) <= 200 and "\n" not in i[key] and "\t" not in i[key]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for path in registry.ROOT.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_.-]+$", path.name), path


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a mix, a limit and a metric reader added as files
    alone are found, and the files that were there are unchanged."""
    root = tmp_path / "portbench"
    shutil.copytree(registry.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "mixtral-8x7b.json").read_text())
    (root / "configs" / "new-model.json").write_text(json.dumps({**cfg, "name": "new-model"}))
    mix = json.loads((root / "traffic" / "offline_isl2k.json").read_text())
    (root / "traffic" / "new_mix.json").write_text(json.dumps({**mix, "name": "new_mix"}))
    (root / "limits" / "new-model.new_mix.json").write_text('{"mean_logit_gap": 1.0}')
    (root / "metrics" / "new.metric.py").write_text(
        'LAYER = "Model"\nUNIT = "ms"\nSOURCE = "device_trace"\nMOVES = "new_tok_s"\n'
        'BETTER = "lower"\n\n\ndef read(obs):\n    return obs.device_ms_per_step\n')
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "new-model.new_mix", "config": "new-model",
                               "traffic": "new_mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "new.metric", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "Model",
                               "moves": "new_tok_s"})
    bench["end_to_end"].append({"name": "new_tok_s", "unit": "tokens/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["new-model.new_mix"]})
    cell = registry.cell("new-model.new_mix", bench, root)
    assert cell.config["name"] == "new-model" and cell.traffic["name"] == "new_mix"
    assert "new.metric" in cell.per_layer and "new_tok_s" in cell.end_to_end
    assert "new.metric" in registry.metric_readers(root)
    assert registry.driver(cell.traffic["driver"]).run
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_run_imports_no_jax():
    """Every module of the benchmark, imported in a fresh process, loads no
    module whose top-level name is jax, jaxlib, flax or fused4bit_tpu
    (compared whole: fused4bit_tpu_torch is the port)."""
    code = (
        "import sys, pathlib, importlib\n"
        "import portbench.run, portbench.harness, portbench.calibrate, portbench.trace\n"
        "import portbench.drivers.decode, portbench.reference.mixtral, portbench.card\n"
        "from portbench import registry\n"
        "registry.metric_readers()\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=registry.REPO, check=True).stdout
    tops = set(eval(out.strip().splitlines()[-1]))
    assert "fused4bit_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "fused4bit_tpu"}, tops & {"jax", "flax"}
    for path in registry.ROOT.rglob("*.py"):
        src = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|fused4bit_tpu)\b(?!_torch)",
                             src, re.M), path


def test_the_reference_takes_nothing_of_the_program():
    src = (registry.ROOT / "reference" / "mixtral.py").read_text()
    assert "fused4bit_tpu_torch" not in src
    code = ("import sys; import portbench.reference.mixtral\n"
            "print(any(m.startswith('fused4bit_tpu') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=registry.REPO, check=True).stdout
    assert out.strip() == "False"
