"""Run one cell of the port's benchmark and print its result line.

    python3 gwbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, mix, limits and per-layer metrics are the files named after
them under ``gwbench/`` (see `gwbench`).  A run draws its inputs from
``--seed``, warms up every shape the window uses (set-up), measures for
``--seconds`` seconds, then frees the program's state and compares the
answers it kept with the plain reference (`gwbench.reference`).  With
``--trace 0`` the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled stretch inside
the window.  The last line of standard output is the result, as JSON; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.

It needs an NVIDIA card (``torch.cuda``) and exits with 2 without one; it
exits with 3 if JAX, ``flax`` or the reference package ``repro`` is loaded
once the window has closed.  The kernels build under ``build/`` in the
checkout (`repro_torch.kernels.build`), so only a checkout's first run
compiles.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "gwbench"
#: top-level modules that must not be loaded in a run of the port
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def _paths() -> None:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # a library the port might load must not pull JAX in by itself
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(bench: dict, name: str):
    """The cell ``name``: (its workload entry, `common.Cell`)."""
    from gwbench.common import Cell
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return w, Cell(name=name, config=load_json(ROOT / conf["file"]),
                   traffic=load_json(HERE / "traffic" /
                                     f"{w['traffic']}.json"),
                   limits=load_json(HERE / "limits" / f"{name}.json"))


def metrics_for(bench: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` this cell reports: those listing it, and
    the end-to-end metrics that list no cells (``setup_s``).  A per-layer
    metric lists its cells."""
    if section == "end_to_end":
        return [m for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def read_metric(name: str, ctx):
    """``metrics/<name>.py``'s reading of ``ctx``, or None."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gwbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(BANNED))


def card_line() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[0] if out else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(bench: dict, name: str, seed: int, seconds: float, traced: bool,
             device, variant: dict | None = None, cell=None,
             sink: dict | None = None) -> dict:
    """One run of the cell ``name``; returns the result (without printing
    it).  ``cell`` replaces the resolved `common.Cell` (the tests run a
    cell's driver at a small size on the CPU); ``variant`` selects the
    control's lower-precision path (`gwbench.readings`); ``sink``, a dict,
    receives the driver under "driver"."""
    import torch

    from gwbench import check, drivers, peaks
    entry, resolved = resolve(bench, name)
    cell = cell or resolved
    # every configuration states float32 products without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = drivers.load(cell.traffic["driver"])(cell, seed, device,
                                                  variant)
    if sink is not None:
        sink["driver"] = driver
    driver.setup()
    win = driver.window(seconds, traced)
    setup_s = win.opened - T_START
    dev_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
    win.ctx.peaks = peaks.for_device(dev_name) if device.type == "cuda" \
        else None
    driver.release()
    readings = driver.compare()
    checks = check.checks(cell.limits, readings)
    metrics = {}
    if traced:
        for m in metrics_for(bench, name, "per_layer"):
            v = read_metric(m["name"], win.ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(win.e2e, setup_s=setup_s)
        for m in metrics_for(bench, name, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": dev_name, "count": int(entry["chips"]),
           "memory_peak_bytes": win.peak_bytes}
    if device.type == "cuda":
        dev["power_limit"] = card_line()
    out = {"correct": all(c.ok for c in checks), "attempted": win.attempted,
           "failed": win.failed, "metrics": metrics, "device": dev}
    if traced and win.ctx.trace is not None:
        dev["busy_s"] = win.ctx.trace.busy_s
        dev["window_s"] = win.ctx.trace.window_s
        out["breakdown"] = win.ctx.trace.breakdown()
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    for c in checks:
        print(c.line(), file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = next((int(w["chips"]) for w in bench["workloads"]
                  if w["name"] == args.workload), 1)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA device(s); found {found}: the benchmark "
              "measures the card and never the CPU", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0))
    loaded = banned_modules()
    if loaded:
        print(f"loaded in the run's process: {', '.join(loaded)} (the port "
              "must load neither JAX nor the reference package)",
              file=sys.stderr)
        return 3
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    _paths()
    sys.exit(main())
