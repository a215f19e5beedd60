#!/usr/bin/env python3
"""Time the Sinkhorn half-step kernels (B1 row, B2 column), the fused FGC
D̃ apply (B3), the FGC L apply (B4, as L and as Lᵀ), the Dykstra half-sweep
(B5), the factor Gram chain (B6) and the gradient assembly (B7) of one
source tree on one NVIDIA card.

    python3 tools/half_step_times.py [--src DIR] [--reps 50] [--only KIND]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), builds
its kernels, and times each kernel with CUDA events at the main path's
shapes: the half-steps at 8192 × 8192 in f32, f64 and bf16 C under f32 duals
(Run A), 4096 × 4096 in f64 (Run B), and 8192 × 8191 in f32 (rows that are
not 16-byte aligned); B5 at N = 10⁶, r = 16 in f32, f64 and bf16 lk under
f32 duals (Run C), N = 10⁵ at r = 8, 16, 32 in f64 (Run D) and N = 8192, r =
16 in f64 (Run E); B3 (p = 1 unless stated) on x of 8192 × 8192 in f32 and
f64 (Run A's gradient), 64 × 262144 in f64 at p = 1 and 2 (Run B's), 8192 ×
16 in f64 (Run E's D_X Q) and 8192 × 1 in f32 and f64 at p = 1 and 2 (the
squared-distance applies); B4's L and Lᵀ at p = 1 on 8192 × 8192, 8192 ×
16 and 8192 × 1 in f32 and f64, and the public ``apply_L``/``apply_LT``
(``backend="kernel"``, the whole call) at 8192² f32 — on a tree whose B4
wrapper has no ``reverse`` (before the reversed scan) Lᵀ is timed as
``apply_LT``, its two flips included, and labelled so; B6 and B7 at N =
10⁶, c = 5, r = 16 in f32 and f64 (Run C) and N = 10⁵ at r = 8, 16, 32 in
f64 (Run D). B5, B6 and B7 are
timed twice: back to back on the same inputs ("warm": at 10⁵ and 8192 rows
they stay in the 50 MB L2), and each launch after a 64 MB write that
flushes L2 ("cold", an event pair around each launch). Before each timed
stretch the card sleeps while the host enqueues
it, so the events time the kernels, not the host's issue; the host's own
time a call is printed beside them ("host_ms"). Inputs come from a fixed
seed, so two trees see the same data. Prints the card, then one JSON line a
case with the time, the bytes bound (the inputs read once, the outputs
written once) and the share of it reached. To compare two trees, run it on
each in turns (A, B, B, A) in one session on one card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12              # H100 SXM, NVIDIA data sheet
SEED = 20240413
SLEEP_CYCLES = 20_000_000              # ~10 ms at the H100's 1.98 GHz
FGC_CASES = (("f32", 8192, 8192, 1), ("f64", 8192, 8192, 1),
             ("f64", 64, 262144, 1), ("f64", 64, 262144, 2),
             ("f32", 8192, 16, 1), ("f64", 8192, 16, 1), ("f32", 8192, 1, 1),
             ("f64", 8192, 1, 1),
             ("f32", 8192, 1, 2), ("f64", 8192, 1, 2))
LR_CASES = (("f32", 10 ** 6, 16, "float32", "float32"),
            ("f64", 10 ** 6, 16, "float64", "float64"),
            ("bf16-lk/f32", 10 ** 6, 16, "float32", "bfloat16"),
            ("f64", 10 ** 5, 8, "float64", "float64"),
            ("f64", 10 ** 5, 16, "float64", "float64"),
            ("f64", 10 ** 5, 32, "float64", "float64"),
            ("f64", 8192, 16, "float64", "float64"))
GRAD_CASES = (("f32", 10 ** 6, 5, 16), ("f64", 10 ** 6, 5, 16),
              ("f64", 10 ** 5, 5, 8), ("f64", 10 ** 5, 5, 16),
              ("f64", 10 ** 5, 5, 32))
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
    ap.add_argument("--only", choices=("half", "dykstra", "fgc", "lowrank"))
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
    if args.only in (None, "half"):
        half_steps(torch, ops, gen, start, end, args)
    if args.only in (None, "fgc"):
        fgc(torch, ops, gen, start, end, args)
    if args.only in (None, "dykstra"):
        dykstra(torch, ops, gen, start, end, args)
    if args.only in (None, "lowrank"):
        lowrank(torch, ops, gen, start, end, args)
    return 0


def warm_cold(torch, fn, start, end, flush, reps):
    """(warm ms, cold ms, host ms) of fn: back to back with the card kept
    busy while the host enqueues, then each launch after an L2 flush."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    end.record()
    torch.cuda.synchronize()
    warm = start.elapsed_time(end) / reps
    cold = 0.0
    for _ in range(reps):
        flush.fill_(1)
        torch.cuda._sleep(SLEEP_CYCLES // 20)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        cold += start.elapsed_time(end)
    return warm, cold / reps, host


def lowrank(torch, ops, gen, start, end, args):
    """B6 and B7 at Runs C and D's shapes; bounds count the inputs read
    once and the outputs written once."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for tag, n, c, r in GRAD_CASES:
        dt = torch.float32 if tag == "f32" else torch.float64
        vb = torch.finfo(dt).bits // 8
        a, b = (torch.randn((1, n, c), generator=gen, device="cuda",
                            dtype=dt) for _ in range(2))
        q = torch.rand((1, n, r), generator=gen, device="cuda",
                       dtype=dt) / n
        w = torch.rand((1, n), generator=gen, device="cuda", dtype=dt)
        wm = torch.randn((1, c, r), generator=gen, device="cuda", dtype=dt)
        s_, t_, iq = (torch.randn((1, r), generator=gen, device="cuda",
                                  dtype=dt) for _ in range(3))
        cases = (
            ("gram_chain", lambda: ops.lr_gram_chain_batched(a, b, q, w),
             (n * (2 * c + r + 1) + c * r + r * r + 2 * r) * vb),
            ("grad_combine",
             lambda: ops.lr_grad_combine_batched(a, wm, w, s_, t_, iq),
             (n * (c + 1 + r) + c * r + 3 * r) * vb))
        for kernel, fn, nbytes in cases:
            warm, cold, host = warm_cold(torch, fn, start, end, flush,
                                         args.reps)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            print(json.dumps({"src": args.src, "kernel": kernel,
                              "dtype": tag, "n": n, "c": c, "r": r,
                              "ms": warm, "cold_ms": cold, "host_ms": host,
                              "bound_ms": bound, "of_bound": bound / warm}),
                  flush=True)
        del a, b, q, w


def fgc(torch, ops, gen, start, end, args):
    from repro_torch.core import fgc as core_fgc
    reverse = "reverse" in inspect.signature(ops.fgc_apply_l).parameters
    for tag, n, cols, p in FGC_CASES:
        dt = torch.float32 if tag == "f32" else torch.float64
        x = torch.randn((n, cols), generator=gen, device="cuda", dtype=dt)
        # x read once and y written once
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        cases = {"dtilde": lambda: ops.fgc_apply_dtilde(x, p)}
        if n == 8192 and p == 1:
            cases["l"] = lambda: ops.fgc_apply_l(x, p)
            if reverse:
                cases["lt"] = lambda: ops.fgc_apply_l(x, p, reverse=True)
            else:
                cases["lt as apply_LT, flips included"] = \
                    lambda: core_fgc.apply_LT(x, 0, p, "kernel")
            if cols == n and tag == "f32":
                cases["apply_L"] = lambda: core_fgc.apply_L(x, 0, p, "kernel")
                cases["apply_LT"] = \
                    lambda: core_fgc.apply_LT(x, 0, p, "kernel")
        for kernel, fn in cases.items():
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn()
            host = (time.perf_counter() - t0) / args.reps * 1e3
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / args.reps
            print(json.dumps({"src": args.src, "kernel": kernel,
                              "dtype": tag, "n": n, "cols": cols, "p": p,
                              "ms": ms, "host_ms": host, "bound_ms": bound,
                              "of_bound": bound / ms}), flush=True)
        del x


def dykstra(torch, ops, gen, start, end, args):
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for tag, n, r, dname, lname in LR_CASES:
        dt = getattr(torch, dname)
        lk = torch.randn((1, n, r), generator=gen, device="cuda",
                         dtype=dt).to(getattr(torch, lname))
        gcol = torch.randn((1, r), generator=gen, device="cuda", dtype=dt)
        logw = torch.full((1, n), -math.log(n), device="cuda", dtype=dt)
        vb = torch.finfo(dt).bits // 8
        # lk, gcol and log w read once, f and col written once
        nbytes = lk.numel() * lk.element_size() + (2 * n + 2 * r) * vb
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        warm, cold, host = warm_cold(
            torch, lambda: ops.lr_dykstra_half_batched(lk, gcol, logw),
            start, end, flush, args.reps)
        print(json.dumps({"src": args.src, "kernel": "dykstra", "dtype": tag,
                          "n": n, "r": r, "ms": warm, "cold_ms": cold,
                          "host_ms": host, "bound_ms": bound,
                          "of_bound": bound / warm}),
              flush=True)
        del lk


def half_steps(torch, ops, gen, start, end, args):
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


if __name__ == "__main__":
    sys.exit(main())
