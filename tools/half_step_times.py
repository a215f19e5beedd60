#!/usr/bin/env python3
"""Time the Sinkhorn half-step kernels (B1 row, B2 column) of one source
tree on one NVIDIA card.

    python3 tools/half_step_times.py [--src DIR] [--reps 50]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), builds
its kernels, and times each half-step with CUDA events at the dense main
path's shapes: 8192 × 8192 in f32, f64 and bf16 C under f32 duals (Run A),
4096 × 4096 in f64 (Run B), and 8192 × 8191 in f32 (rows that are not
16-byte aligned).  Inputs come from a fixed seed, so two trees see the same
data.  Prints the card, then one JSON line a case with the time, the bytes
bound (C read once, the vectors once) and the share of it reached.  To
compare two trees, run it on each in turns (A, B, B, A) in one session on
one card.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12              # H100 SXM, NVIDIA data sheet
SEED = 20240413
CASES = (("f32", 8192, 8192, "float32", "float32"),
         ("f64", 8192, 8192, "float64", "float64"),
         ("bf16-C/f32", 8192, 8192, "float32", "bfloat16"),
         ("f64", 4096, 4096, "float64", "float64"),
         ("f32", 8192, 8191, "float32", "float32"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    from repro_torch.kernels import build, ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    build.build_all()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for tag, m, n, dname, cname in CASES:
        dt, cdt = getattr(torch, dname), getattr(torch, cname)
        cost = torch.rand((1, m, n), generator=gen, device="cuda",
                          dtype=dt).to(cdt)
        vecs = {"row": (torch.randn((1, n), generator=gen, device="cuda",
                                    dtype=dt),
                        torch.full((1, m), -math.log(m), device="cuda",
                                   dtype=dt)),
                "col": (torch.randn((1, m), generator=gen, device="cuda",
                                    dtype=dt),
                        torch.full((1, n), -math.log(n), device="cuda",
                                   dtype=dt))}
        eps = torch.full((1,), 2e-3, device="cuda", dtype=dt)
        for kind in ("row", "col"):
            vec, logw = vecs[kind]
            # C, the dual vector and log w read once, the output written once
            nbytes = cost.numel() * cost.element_size() + \
                (vec.numel() + 2 * logw.numel()) * vec.element_size()
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            fn = getattr(ops, f"sinkhorn_{kind}_update_batched")
            fn(cost, vec, logw, eps)
            torch.cuda.synchronize()
            start.record()
            for _ in range(args.reps):
                fn(cost, vec, logw, eps)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / args.reps
            print(json.dumps({"src": args.src, "kernel": kind, "dtype": tag,
                              "m": m, "n": n, "ms": ms, "bound_ms": bound,
                              "of_bound": bound / ms}), flush=True)
        del cost
    return 0


if __name__ == "__main__":
    sys.exit(main())
