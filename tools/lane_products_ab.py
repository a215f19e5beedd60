#!/usr/bin/env python3
"""Time the main path's calls whose dense and factored geometry applies
run through the batch's matrix products, on one source tree and one
NVIDIA card:

    python3 tools/lane_products_ab.py [--src DIR] [--reps 3]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``),
builds its kernels, and times, on the host clock around synchronised
work, after one warm-up call each:

- ``I f32`` / ``I f64``: the trainer's batched FGW alignment loss and its
  backward pass (chip_smoke.py's Run I: 8 ragged pairs of 1536–2048
  tokens at d 2048, kernels route), dense (B, N, N) applies in both;
- ``N(c) dense`` / ``N(c) kernel``: sliced GW's grid method, 32 lanes of
  ``entropic_gw_batch`` on two 10⁶-point clouds (Run N(c), kernels route,
  on the dense and the kernel FGC backends);
- ``G``: 4 ragged 10⁵-point cloud lanes on the factored plan at rank 16
  (Run G), whose factored applies are a long contraction into a tiny
  output.

Inputs come from chip_smoke.py's seeds, so two trees see the same data.
Prints the card, then one JSON line a case with each repetition's wall
in seconds.  To compare two trees, run it on each in turns (A, B, B, A)
in one session on one card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 20240413
LANES_I, S_I_MIN, S_I_MAX, D_I = 8, 1536, 2048, 2048
N_N, P_N_GRID, GRID_N = 1_000_000, 32, 512
N_AXES = (1.0, 2.0, 3.0)
N_G, N_G_MIN, LANES_G, R_LR = 100_000, 80_000, 4, 16
LR_CONTROLS = dict(eps=5e-2, outer_iters=40, sinkhorn_iters=50, tol=1e-6,
                   eps_init=0.5, anneal_decay=0.7, plan="lowrank",
                   lr_gamma=30.0)


def ragged_sizes(np, lo, hi, lanes, seed):
    return np.random.default_rng(seed).integers(lo, hi + 1, size=(lanes, 2))


def box_cloud(np, n, seed, scale=1.0):
    r = np.random.default_rng(seed)
    axes = np.asarray(N_AXES)
    pts = (r.random((n, 3)) - 0.5) * axes * scale
    w = np.exp(0.5 * (pts / (axes * scale)).sum(axis=1))
    return pts, w / w.sum()


def cases(torch, np, core):
    """{name: a call that runs the case once and returns a tensor}."""
    sizes = ragged_sizes(np, S_I_MIN, S_I_MAX, LANES_I, SEED + 40)
    rng = np.random.default_rng(SEED + 41)
    student = [rng.standard_normal((int(s), D_I), dtype=np.float32)
               for s, _ in sizes]
    teacher = [rng.standard_normal((int(t), D_I), dtype=np.float32)
               for _, t in sizes]
    align = core.AlignConfig(theta=0.5, outer_iters=3, sinkhorn_iters=30)

    def run_i(dt):
        hs = [torch.tensor(x, device="cuda", dtype=dt, requires_grad=True)
              for x in student]
        ht = [torch.tensor(x, device="cuda", dtype=dt) for x in teacher]
        loss = core.fgw_alignment_loss_batch(hs, ht, align)
        return torch.autograd.grad(loss, hs)[0]

    a, wa = box_cloud(np, N_N, SEED + 90)
    b, wb = box_cloud(np, N_N, SEED + 91, scale=1.3)
    clouds = [core.PointCloudGeometry(torch.tensor(p, device="cuda"))
              for p in (a, b)]
    weights = [torch.tensor(w, device="cuda") for w in (wa, wb)]

    def run_n(fgc):
        return core.sliced_gw(*clouds, *weights, n_proj=P_N_GRID,
                              method="grid", grid_n=GRID_N, grid_backend=fgc,
                              sinkhorn_backend="auto", device="cuda").estimate

    g_sizes = ragged_sizes(np, N_G_MIN, N_G, LANES_G, SEED + 22)

    def cloud(n, seed):
        pts = np.random.default_rng(seed).normal(size=(n, 3))
        return core.PointCloudGeometry(torch.tensor(pts, device="cuda"))

    probs = [(cloud(int(m), SEED + 200 + 2 * k),
              cloud(int(n), SEED + 201 + 2 * k),
              torch.full((int(m),), 1.0 / m, dtype=torch.float64,
                         device="cuda"),
              torch.full((int(n),), 1.0 / n, dtype=torch.float64,
                         device="cuda"))
             for k, (m, n) in enumerate(g_sizes)]
    g_cfg = core.GWConfig(plan_rank=R_LR, **LR_CONTROLS)

    def run_g():
        return core.entropic_gw_batch(probs, g_cfg,
                                      pad_to=(N_G, N_G))[0].value

    return {"I f32": lambda: run_i(torch.float32),
            "I f64": lambda: run_i(torch.float64),
            "N(c) dense": lambda: run_n("dense"),
            "N(c) kernel": lambda: run_n("kernel"),
            "G": run_g}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch

    from repro_torch import core
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}; tree: {Path(args.src).resolve()}", flush=True)
    build.build_all()
    for name, fn in cases(torch, np, core).items():
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(json.dumps({"case": name, "walls_s": walls,
                          "src": str(Path(args.src).resolve())}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
