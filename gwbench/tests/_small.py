"""The cells at a size a CPU test run can hold: the same configurations,
mixes and limits, with fewer points and iterations."""
import copy

import torch

from gwbench import run

SMALL = {
    "grid1d-log.solve-8192": {
        "traffic": {"n": 32, "pool": 3},
        "solver": {"outer_iters": 4, "sinkhorn_iters": 50}},
    "grid2d-kmode.solve-128": {
        "traffic": {"n": 6, "pool": 3},
        "solver": {"outer_iters": 3, "sinkhorn_iters": 10}},
    "grid1d-log.serve-1k2k": {
        "traffic": {"sizes": [24, 40], "bank": 64, "warmup": 4,
                    "trace": [0.1, 0.3],
                    "check": {"per_class": 2},
                    "engine": {"scheduler": "continuous", "max_batch": 4,
                               "size_bucket": 64, "segment_iters": 3,
                               "max_inflight_buckets": 2,
                               "cache_capacity": 0}},
        "solver": {"outer_iters": 8, "sinkhorn_iters": 60}},
}
CELLS = tuple(SMALL)
SECONDS = {"grid1d-log.serve-1k2k": 1.5}
CPU = torch.device("cpu")


def bench() -> dict:
    return run.load_json(run.ROOT / "BENCHMARK.json")


def cell(name: str):
    """The cell ``name`` resolved from the repository's files, cut to a
    small size."""
    _, c = run.resolve(bench(), name)
    c = copy.deepcopy(c)
    small = SMALL[name]
    c.traffic.update(small["traffic"])
    c.traffic["solver"] = {**c.traffic.get("solver", {}), **small["solver"]}
    return c


def run_small(name: str, seed: int = 2 ** 31 + 5, traced: bool = False,
              variant=None) -> dict:
    return run.run_cell(bench(), name, seed, SECONDS.get(name, 0.2), traced,
                        CPU, variant=variant, cell=cell(name))
