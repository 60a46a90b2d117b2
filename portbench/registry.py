"""Where the benchmark finds its parts, by name.

Every configuration, traffic mix, per-layer metric and cell limit is a file
of its own under the benchmark's folder, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model's published sizes, ``source``,
  ``reduced``, ``assumed``, the quantization and the deployment it stands
  for;
* ``traffic/<mix>.json``: the mix's parameters and the driver that runs it
  (``drivers/<driver>.py``, one general driver per kind of mix);
* ``metrics/<metric>.py``: one reader per per-layer metric;
* ``limits/<config>.<mix>.json``: the limit of each number that decides
  ``correct`` in that cell.

Adding a configuration, a mix, a metric or a cell adds files; no existing
file changes. ``root`` is the benchmark's folder (this package's, unless a
test points elsewhere).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Dict, Optional

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent

# What every metric reader declares.
READER_FIELDS = ("LAYER", "UNIT", "SOURCE", "MOVES", "BETTER")


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str, root: pathlib.Path = ROOT) -> dict:
    return _json(root / "configs" / f"{name}.json")


def traffic(name: str, root: pathlib.Path = ROOT) -> dict:
    return _json(root / "traffic" / f"{name}.json")


def limits(cell: str, root: pathlib.Path = ROOT) -> dict:
    return _json(root / "limits" / f"{cell}.json")


def manifest(repo: pathlib.Path = REPO) -> dict:
    return _json(repo / "BENCHMARK.json")


def _load_module(path: pathlib.Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_readers(root: pathlib.Path = ROOT) -> Dict[str, ModuleType]:
    """Every ``metrics/<name>.py``, loaded, by metric name. Each declares
    ``LAYER``, ``UNIT``, ``SOURCE``, ``MOVES`` and ``BETTER`` and has
    ``read(obs) -> float | None``."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        name = path.name[: -len(".py")]
        mod = _load_module(path, f"portbench_metric_{len(out)}")
        missing = [f for f in READER_FIELDS + ("read",) if not hasattr(mod, f)]
        if missing:
            raise AttributeError(f"metric reader {path} lacks {missing}")
        out[name] = mod
    return out


def driver(name: str) -> ModuleType:
    """``drivers/<name>.py``: the code that runs a traffic mix."""
    return importlib.import_module(f"portbench.drivers.{name}")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    per_layer: tuple        # the per-layer metric names this cell reports
    end_to_end: tuple       # the end-to-end metric names this cell reports
    units: dict             # every metric's unit, by name


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Optional[dict] = None, root: pathlib.Path = ROOT) -> Cell:
    bench = manifest() if bench is None else bench
    matches = [w for w in bench["workloads"] if w["name"] == name]
    if not matches:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = matches[0]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=config(w["config"], root), traffic=traffic(w["traffic"], root),
        limits=limits(name, root),
        per_layer=tuple(m["name"] for m in bench["per_layer"] if _reports(m, name)),
        end_to_end=tuple(m["name"] for m in bench["end_to_end"] if _reports(m, name)),
        units={m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]},
    )
