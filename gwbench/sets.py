"""Run a cell several times, each run a process of its own, and report the
spread of every metric.

    python3 gwbench/sets.py --workload <cell> --seeds 1,2,3 --seconds <s> \
        [--trace 0|1] [--out chiprun_out/<file>.jsonl]

Runs ``gwbench/run.py`` once a seed, one after another, and prints each
run's result line, then for each metric its readings, median and spread:
the distance between the first and third quartiles
(`statistics.quantiles(values, n=4)`) as a share of the median, over all
runs and with the run farthest from the median left out.  A run that
fails keeps the end of its standard error in the record.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values) -> float:
    """(Q3 − Q1) / median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else float("nan")


def trimmed(values) -> list:
    """The values without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(ROOT / "gwbench" / "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    rec = {"seed": seed, "rc": p.returncode, "trace": trace}
    lines = p.stdout.strip().splitlines()
    try:
        rec["result"] = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        rec["result"] = None
    rec["stderr_tail"] = p.stderr[-3000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    recs = []
    for s in args.seeds.split(","):
        rec = one(args.workload, int(s), args.seconds, args.trace)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    ok = [r["result"] for r in recs if r["result"] is not None]
    names = sorted({m for r in ok for m in r["metrics"]})
    for m in names:
        vals = [r["metrics"][m]["value"] for r in ok if m in r["metrics"]]
        line = {"metric": m, "values": vals,
                "median": statistics.median(vals)}
        if len(vals) >= 3:
            line["spread"] = spread(vals)
        if len(vals) >= 4:
            line["spread_trimmed"] = spread(trimmed(vals))
        print(json.dumps(line), flush=True)
    print(json.dumps({"runs": len(recs), "results": len(ok),
                      "correct": [r["correct"] for r in ok]}))
    return 0 if len(ok) == len(recs) else 1


if __name__ == "__main__":
    sys.exit(main())
