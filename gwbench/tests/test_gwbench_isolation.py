"""What the benchmark may load: nothing of JAX, of the reference package
``repro`` or of the JAX package's harness ``benchmarks``, and in its plain
reference nothing of the program either.  Names are compared by their
top-level part as a whole (``repro_torch`` is not ``repro``)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from gwbench import run

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: Path) -> set[str]:
    """The top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_banned_import(path):
    assert not imported(path) & BANNED


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)
    assert imported(path) <= {"__future__", "contextlib", "dataclasses",
                              "torch", "gwbench"}


def test_no_banned_module_loaded():
    """Every module of the benchmark, imported in a fresh process (the
    per-layer metrics by their paths, as the harness loads them), with the
    program's package: none of the banned names is in ``sys.modules``."""
    code = f"""
import importlib, importlib.util, json, sys
from pathlib import Path
sys.path[:0] = [{str(HERE.parent / "src")!r}, {str(HERE.parent)!r}]
import repro_torch.core, repro_torch.serve.engine
for p in sorted(Path({str(HERE)!r}).rglob("*.py")):
    if "__pycache__" in p.parts or p.name == "conftest.py":
        continue
    rel = p.relative_to(Path({str(HERE.parent)!r})).with_suffix("")
    if p.parent.name == "metrics":
        spec = importlib.util.spec_from_file_location(
            "m_" + p.stem.replace(".", "_"), p)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    elif p.parent.name != "tests":
        importlib.import_module(".".join(rel.parts))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "gwbench" in loaded and "repro_torch" in loaded
    assert not loaded & BANNED


def test_run_refuses_without_a_card(monkeypatch, capsys):
    """The measurement path fails without a card: no result line, exit 2,
    no fall-back to the CPU."""
    import torch
    monkeypatch.setenv("USE_FLAX", "0")
    monkeypatch.setenv("USE_JAX", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "grid1d-log.solve-8192", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
    assert "CUDA" in out.err


def test_banned_modules_are_found(monkeypatch):
    """A banned top-level name is found from any of its submodules, and a
    name that only begins like one is not."""
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    monkeypatch.setitem(sys.modules, "reprox", object())
    found = run.banned_modules()
    assert "flax" in found and "reprox" not in found
