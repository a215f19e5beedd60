"""Import boundary: the port (its serving, training, data, checkpoint,
distributed and launch packages included), its chip smoke script and its
timing tools import neither JAX nor anything of the reference package
``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_port():
    names = {p.name for p in FILES}
    assert {"chip_smoke.py", "gw.py", "ops.py", "sinkhorn_step.py",
            "fgc_scan.py", "lr_step.py", "convert.py",
            "half_step_times.py", "fgw.py", "losses.py", "ugw.py", "coot.py",
            "barycenter.py", "sliced.py", "engine.py", "cache.py",
            "calibration.py", "serve.py", "attention.py", "mlp.py",
            "ssm.py", "blocks.py", "lm.py", "common.py", "shapes.py",
            "smollm_360m.py", "zamba2_7b.py", "pipeline.py", "optimizer.py",
            "loop.py", "manager.py", "fault_tolerance.py", "sharding.py",
            "train.py", "flops.py", "mesh.py", "collectives.py", "specs.py",
            "dryrun.py"} <= names
    for sub in ("data", "train", "checkpoint", "distributed"):
        assert ROOT / "src" / "repro_torch" / sub / "__init__.py" in FILES


def test_importing_the_mesh_module_starts_no_process_group():
    """As the reference's ``launch/mesh.py``: the meshes are built by
    functions, so an import touches no process group (a fresh
    interpreter, so that nothing else has started one)."""
    code = ("import torch.distributed as d, repro_torch.launch.mesh as m, "
            "repro_torch.launch.collectives; "
            "assert not d.is_initialized(); "
            "assert callable(m.make_mesh) and callable(m.local_mesh)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]


def test_importing_the_dry_run_starts_no_process_group():
    """The dry run starts its fake group inside `run_cell`, and its specs
    build nothing at import (a fresh interpreter)."""
    code = ("import torch.distributed as d, repro_torch.launch.dryrun as m, "
            "repro_torch.launch.specs; "
            "assert not d.is_initialized(); "
            "assert callable(m.run_cell) and callable(m.main)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
