#!/usr/bin/env python3
"""The factored-plan gradient's spread between the kernel and the plain
forward on random 3-D clouds (300 and 260 points, rank 6, γ = 5, ε = 5e-2,
100 outer steps, which stop unconverged), on one NVIDIA card:

    python3 tools/grad_spread_3d.py

Prints each route's value and counts, then max |Δ| over max |gradient| of
the gradients in the points and in μ.  `tests/test_torch_cuda.py` holds
this spread to the reference's own pallas-against-xla spread on the same
inputs (`tests/reference_spreads.py`)."""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (GWConfig, PointCloudGeometry,  # noqa: E402
                              entropic_gw)


def measures(n, seed):
    u = np.random.default_rng(seed).random(n) + 0.05
    return u / u.sum()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    m, n = 300, 260
    mu, nu = measures(m, 3), measures(n, 4)
    px = np.random.default_rng(5).normal(size=(m, 3))
    py = np.random.default_rng(6).normal(size=(n, 3))
    grads = {}
    for route in ("auto", "torch"):
        pts = torch.tensor(px, device="cuda", requires_grad=True)
        mu_t = torch.tensor(mu, device="cuda", requires_grad=True)
        t0 = time.perf_counter()
        res = entropic_gw(
            PointCloudGeometry(pts),
            PointCloudGeometry(torch.tensor(py, device="cuda")), mu_t, nu,
            GWConfig(eps=5e-2, tol=1e-10, outer_iters=100,
                     sinkhorn_iters=400, plan="lowrank", plan_rank=6,
                     lr_gamma=5.0, lowrank_backend=route))
        grads[route] = torch.autograd.grad(res.value, (pts, mu_t))
        print(f"{route}: value {float(res.value.detach()):.15e}, outer "
              f"{res.info.outer_iters}, inner {res.info.inner_iters}, "
              f"converged {res.info.converged}, "
              f"{time.perf_counter() - t0:.2f} s (the build included)")
    for k, name in enumerate(("points", "mu")):
        a, b = grads["auto"][k], grads["torch"][k]
        print(f"spread in {name}: "
              f"{float((a - b).abs().max() / b.abs().max()):.3e}")
    print(f"card: {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
