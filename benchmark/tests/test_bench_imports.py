"""Nothing under benchmark/ imports JAX or the JAX package, and the reference
imports nothing of the program (top-level names compared whole: the port's
name begins with the JAX package's)."""

import ast

import pytest

from benchmark import spec

JAX = {"jax", "jaxlib", "flax", "rwkv_tpu"}


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


FILES = sorted(spec.HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax(path):
    assert not set(imported(path)) & JAX


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    assert not set(imported(path)) & (JAX | {"rwkv_tpu_torch", "benchmark"})


def test_the_check_of_loaded_modules_compares_whole_names(monkeypatch):
    import sys

    from benchmark import run

    monkeypatch.setitem(sys.modules, "rwkv_tpu_torch_like", sys)
    assert "rwkv_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rwkv_tpu.models", sys)
    assert run.forbidden_modules() == ["rwkv_tpu"]
