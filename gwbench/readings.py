"""Read the numbers that decide ``correct`` over many seeds in one process.

    python3 gwbench/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--control] [--out chiprun_out/<file>.jsonl]

For the program as configured (the lower readings of each limit), or with
``--control`` for the configuration's lower-precision control (its
``control.variant``: a path of the program, or the reference in a lower
precision in the program's place), which has to come out not correct.
Each seed is a whole run of the cell (its inputs, set-up, a window of
``--seconds`` and the comparison); the kernels build once for all of
them.  The benchmark's own runs never run the control.  Prints one JSON
line a seed: the seed, the readings, each limit and ``correct``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                    str(Path(__file__).resolve().parents[1])]

from gwbench import run  # noqa: E402


def readings(name: str, seeds, seconds: float, control: bool, device,
             cell=None) -> list[dict]:
    """One record a seed: {"seed", "correct", "checks"}."""
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    _, resolved = run.resolve(bench, name)
    cell = cell or resolved
    variant = cell.config["control"]["variant"] if control else None
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        sink: dict = {}
        res = run.run_cell(bench, name, seed, seconds, False, device,
                           variant=variant, cell=cell, sink=sink)
        out.append({"seed": seed, "control": control,
                    "correct": res["correct"], "checks": res["checks"],
                    "attempted": res["attempted"],
                    "details": getattr(sink["driver"], "details", None),
                    "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    recs = readings(args.workload, seeds, args.seconds, args.control,
                    torch.device("cuda", 0))
    lines = [json.dumps(r) for r in recs]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
