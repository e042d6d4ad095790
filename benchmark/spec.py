"""BENCHMARK.json and the data files it names, found by name:

    configs/<config>.json        a configuration (sizes, engine settings, family)
    families/<family>.py         a model family's parts (spec.family says which)
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
    here: Path = HERE        # the benchmark's directory, where its files are found

    @property
    def family(self):
        """The module families/<family>.py that the configuration names."""
        return family(self.config, self.here)


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
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        here=here)


def _load(here: Path, folder: str, name: str):
    path = here / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(config: dict, here: Path = HERE):
    """The module families/<family>.py of a configuration. It gives:

    KERNELS                        the program's CUDA sources to build before a card run
    CONTROL                        the precision in which the reference is the control
    tokenizer(cfg)                 the benchmark's own tokenizer (encode, decode,
                                   token_bytes, vocab_size)
    make(cfg, seed, device)        the weights, drawn on the device from the seed
    program(cfg, weights, device)  (engine, pool): the port's engine and its
                                   InferencePool around those weights
    slot_state(pool, slot)         one slot's state, a dict of float64 leaves
    reference(weights, cfg[, precision])
                                   an object whose .run(seqs, logits_from) returns
                                   [(logits, state)] a sequence, from the empty state
    state_err(prog, ref, weights)  the worst error of a slot's state against the
                                   reference's, as a share of the reference
    vocab_rows(weights)            the rows of the logits (the padded vocab)
    """
    return _load(here, "families", config["family"])


def layer_reader(metric: str, here: Path = HERE):
    """The `read(ctx)` function of layer_metrics/<metric>.py."""
    return _load(here, "layer_metrics", metric).read
