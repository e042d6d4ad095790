"""BENCHMARK.json and the data files it names, found by name:

    configs/<config>.json        a configuration (sizes, engine settings)
    traffic/<traffic>.json       a traffic mix (traffic.py reads it)
    checks/<workload>.json       the limits of the correctness comparison
    layer_metrics/<metric>.py    the reader of one per-layer metric

A cell, mix or metric is added by adding files and entries; no code names
one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None, here: Path = HERE) -> Cell:
    bench = bench or load_benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name,
        config=json.loads((here.parent / conf["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
        chips=w["chips"],
        limits=json.loads((here / "checks" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def layer_reader(metric: str, here: Path = HERE):
    """The `read(ctx)` function of layer_metrics/<metric>.py."""
    path = here / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.layer_metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
