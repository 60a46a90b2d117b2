"""A tiny copy of the benchmark's files for the CPU tests: the same drivers
and readers over a 2-layer model of Mixtral's shape at small widths.

The tiny model has 2 experts, both of them each token's top 2: at small
widths with random weights, a near-tied router flips on rounding alone and
moves the logits by whole units, so a choice of experts would make a sound
run's gap as wide as a fault's. Every other part of the path runs as in the
cells."""
from __future__ import annotations

import copy
import json
import pathlib
import shutil
import time

import torch

from portbench import harness, registry, roofline
from portbench.inputs import ModelSpec

TINY = {
    "name": "tiny", "source": "tests", "reference": "mixtral",
    "hidden_size": 256, "intermediate_size": 512, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "num_local_experts": 2,
    "num_experts_per_tok": 2, "vocab_size": 512, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
    "reduced": [], "quantization": {"granularity": "per_row"},
}
# Four sequences of 32 cached positions, 4 steps: the batch rule of the
# cells (``drivers.decode.batch``) on a card that holds just over four.
DECODE = {"name": "tiny_decode", "driver": "decode", "context": 32, "output_tokens": 4,
          "steps": 4, "batch_fill": {"utilization": 1.0, "reserve_bytes": 0, "multiple": 1},
          "kv_std": 1.0, "traced_replays": 1}
# Set from CPU runs of these tiny cells: sound runs' mean gap 0 to 0.029 over
# seeds 1-4 in both granularities, the planted faults' (tests/faults.py)
# 1.02 to 3.33; with 2 experts, both chosen, every route gap is 0.
LIMITS = {"mean_logit_gap": 0.2, "worst_seq_logit_gap": 0.4, "mean_route_gap": 0.1,
          "replays_differing": 0}


def make_root(tmp: pathlib.Path, granularity: str = "per_row") -> tuple:
    """A benchmark folder under ``tmp`` holding the tiny cells, and its
    manifest."""
    root = tmp / "bench"
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(registry.ROOT / "metrics", root / "metrics")
    cfg = copy.deepcopy(TINY)
    cfg["quantization"] = {"granularity": granularity, "group_size": 128}
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    spec = ModelSpec.from_config(cfg)
    mix = copy.deepcopy(DECODE)
    per_seq = roofline.kv_bytes_per_position(spec) * (mix["context"] + mix["output_tokens"])
    mix["batch_fill"]["card_bytes"] = roofline.model_bytes(spec) + 4.5 * per_seq
    (root / "traffic" / "tiny_decode.json").write_text(json.dumps(mix))
    (root / "limits" / "tiny.tiny_decode.json").write_text(json.dumps(LIMITS))
    bench = copy.deepcopy(registry.manifest())
    bench["workloads"] = [{"name": "tiny.tiny_decode", "config": "tiny", "traffic": "tiny_decode",
                           "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.tiny_decode"]
    return root, bench


def run(root, bench, mix: str = "tiny_decode", *, seed: int = 5, seconds: float = 0.5,
        trace: bool = False):
    """One run of ``tiny.<mix>`` on the CPU, past the look for a card."""
    cell = registry.cell(f"tiny.{mix}", bench, root)
    ctx = harness.Context(cell=cell, spec=ModelSpec.from_config(cell.config), seed=seed,
                          seconds=seconds, trace=trace, device=torch.device("cpu"),
                          t_start=time.perf_counter())
    return harness.run_cell(ctx, root)
