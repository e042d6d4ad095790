"""A model family is found by name and lives in files of its own: a second
family runs from new files alone, and no other module of the harness names
RWKV-4's parts."""

import ast
import json
import re
import shutil

import pytest

from benchmark import run, spec
from benchmark.tests.cells import shrink

# RWKV-4's own files: its family module and the files it binds, and the
# per-layer readers that take its frozen arithmetic (arith.py)
FAMILY_FILES = {"families/rwkv4.py", "weights.py", "arith.py", "reference/model.py",
                "reference/tokenizer.py"}
FAMILY_MODULES = ("rwkv_tpu_torch.models.rwkv4", "benchmark.weights", "benchmark.reference.model",
                  "benchmark.arith")
LEAVES = {"xy", "aa", "bb", "pp", "dd"}
NAMED = re.compile(r"rwkv-?4", re.IGNORECASE)

STUB = '''"""RWKV-4 under another name, the leaves of its state renamed."""

from benchmark.families import rwkv4 as base

NAMES = {"xy": "shift_att", "aa": "num", "bb": "den", "pp": "log_scale", "dd": "shift_ffn"}
BACK = {v: k for k, v in NAMES.items()}
KERNELS, CONTROL = base.KERNELS, base.CONTROL
tokenizer, make, program, vocab_rows = base.tokenizer, base.make, base.program, base.vocab_rows


def rename(state, names):
    return {names[k]: v for k, v in state.items()}


def slot_state(pool, slot):
    return rename(base.slot_state(pool, slot), NAMES)


class Reference:
    def __init__(self, ref):
        self.ref = ref

    def run(self, seqs, logits_from):
        return [(logits, rename(st, NAMES)) for logits, st in self.ref.run(seqs, logits_from)]


def reference(weights, cfg, precision="float32"):
    return Reference(base.reference(weights, cfg, precision))


def state_err(prog, ref, weights):
    assert set(prog) == set(ref) == set(BACK)
    return base.state_err(rename(prog, BACK), rename(ref, BACK), weights)
'''


def imported(tree):
    """Every module name an import of `tree` names, with `from a import b` as
    both a and a.b."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def is_family_file(path) -> bool:
    rel = path.relative_to(spec.HERE).as_posix()
    if rel in FAMILY_FILES:
        return True
    return rel.startswith("layer_metrics/") and "benchmark.arith" in imported(
        ast.parse(path.read_text()))


HARNESS = [p for p in sorted(spec.HERE.rglob("*.py"))
           if not p.relative_to(spec.HERE).as_posix().startswith(("tests/", "_"))
           and not is_family_file(p)]


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: p.relative_to(spec.HERE).as_posix())
def test_no_family_named_outside_its_files(path):
    text = path.read_text()
    tree = ast.parse(text)
    bad = [m for m in imported(tree) if any(m == f or m.startswith(f + ".")
                                            for f in FAMILY_MODULES)]
    assert not bad, bad
    leaves = {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
              and isinstance(n.value, str) and n.value in LEAVES}
    leaves |= {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute) and n.attr in LEAVES}
    assert not leaves, leaves
    assert not NAMED.search(text), NAMED.search(text).group(0)


def test_the_harness_outside_the_family_is_checked():
    names = {p.relative_to(spec.HERE).as_posix() for p in HARNESS}
    assert {"run.py", "serve.py", "check.py", "spec.py", "traffic.py", "control.py"} <= names


def test_a_second_family_runs_from_new_files_alone(tmp_path):
    """A family under another name, its state's leaves renamed, added as a
    family module, a configuration, a limits file and entries: its tiny cell
    runs through run_cell on the CPU and comes out correct."""
    here = tmp_path / "benchmark"
    for sub in ("configs", "families", "traffic", "checks", "layer_metrics"):
        shutil.copytree(spec.HERE / sub, here / sub)
    (here / "families" / "stub4.py").write_text(STUB)
    conf = json.loads((spec.HERE / "configs" / "rwkv4-430m-q8.json").read_text())
    conf.update(name="stub-430m", family="stub4")
    (here / "configs" / "stub-430m.json").write_text(json.dumps(conf))
    shutil.copy(spec.HERE / "checks" / "rwkv4-430m-q8.chat.json", here / "checks" / "stub-430m.chat.json")
    bench = spec.load_benchmark()
    bench["configs"].append({"name": "stub-430m", "source": conf["source"],
                             "file": "benchmark/configs/stub-430m.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "stub-430m.chat", "config": "stub-430m",
                               "traffic": "chat", "chips": 1, "why": "a test"})
    cell = shrink(spec.cell("stub-430m.chat", bench=bench, here=here))
    assert cell.family.__file__ == str(here / "families" / "stub4.py")
    out = run.run_cell(cell, 2 ** 35 + 91, 1.5, trace=False, device="cpu")
    assert out["correct"], out["numbers"]
    assert out["numbers"]["states_judged"] > 0 and out["numbers"]["tokens_judged"] > 0
