"""The yardstick imports nothing of the program or of JAX, and the run's
check for JAX compares whole top-level names."""

import ast
import sys
from pathlib import Path

import run

HERE = Path(__file__).resolve().parent.parent


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_and_the_readers_import_no_program():
    allowed = {"numpy", "torch", "reference", "__future__", "statistics",
               "math", "json"}
    for d in ("reference", "metrics"):
        for f in (HERE / d).glob("*.py"):
            for name in _imports(f):
                assert name.split(".")[0] in allowed, (f, name)


def test_nothing_under_the_benchmark_imports_jax():
    for f in HERE.rglob("*.py"):
        for name in _imports(f):
            assert name.split(".")[0] not in run.FORBIDDEN, (f, name)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    mods = dict(sys.modules)
    mods.pop("jax", None)
    mods.update({"orb_slam2_tpu_torch": object(),
                 "orb_slam2_tpu_torch.ops": object()})
    for m in list(mods):
        if m.split(".")[0] in run.FORBIDDEN:
            mods.pop(m)
    monkeypatch.setattr(sys, "modules", mods)
    assert run.forbidden_modules() == []
    mods["orb_slam2_tpu.slam"] = object()
    mods["jaxlib"] = object()
    assert run.forbidden_modules() == ["jaxlib", "orb_slam2_tpu"]
