"""BENCHMARK.json against the contract it is written to."""

import json
import re

from benchmark import e2e as e2e_mod
from benchmark import spec

B = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_keys_and_names():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    metrics = B["end_to_end"] + B["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in B["workloads"]] + \
        [c["name"] for c in B["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in B["workloads"]] + [w["config"] for w in B["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves", "workloads"}
    for text in [w["why"] for w in B["workloads"]] + [c["why"] for c in B["configs"]] + \
            [c["source"] for c in B["configs"]] + [m["layer"] for m in B["per_layer"]] + B["command"]:
        assert LINE.match(text), text
    for c in B["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert len(json.dumps(B)) < 64 * 1024


def test_bounds_and_sources():
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in B["end_to_end"])
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for w in B["workloads"]:
        cell = spec.cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        spec.layer_reader(m["name"])  # a reader of its own, found by name
    for name in e2e:  # each end-to-end name reads a quantity the harness takes
        assert name == "setup_s" or e2e_mod.quantity(name) in e2e_mod.METRICS, name


def test_files_under_paths_and_budget():
    assert B["command"][:2] == ["python3", "benchmark/run.py"] and B["paths"] == ["benchmark"]
    for c in B["configs"]:
        assert c["file"].startswith("benchmark/") and (spec.ROOT / c["file"]).is_file()
        conf = json.loads((spec.ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
    files = [c["file"] for c in B["configs"]]
    assert len(files) == len(set(files))
    for w in B["workloads"]:
        assert w["chips"] == 1
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (spec.HERE / "checks" / f"{w['name']}.json").is_file()
    assert len({(w["config"], w["traffic"]) for w in B["workloads"]}) == len(B["workloads"])
    # a full check of 24 cells fits in 12 hours at this window
    rs = B["run_seconds"]
    assert 1 <= rs <= 51 and 2 + 14 * 24 * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
