"""Fault tolerance: restart supervision, heartbeats, straggler detection.

Reference: ``repro/distributed/fault_tolerance.py``, kept as the port's own
copy (it needs numpy only).  Multi-host failure handling is expressed as
host-level primitives with file-based transport (what a cluster launcher
would wire to its control plane), tested by simulation:

  * ``run_with_restarts`` — supervises a train function; on a crash it
    restarts from the latest valid checkpoint, up to ``max_restarts``
    (the checkpoint manager's atomicity means a crashed save is never
    resumed from).
  * ``Heartbeat`` — a per-host heartbeat file and a ``stale_hosts`` scan:
    the supervisor evicts hosts whose beat is older than the timeout and
    relaunches with the survivors.
  * ``StragglerDetector`` — per-step timing outliers (median + k·MAD),
    the trigger for re-scheduling slow hosts; deterministic data sharding
    makes re-issuing their work trivial.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np


def run_with_restarts(train_fn: Callable[[Optional[int]], int],
                      manager, max_restarts: int = 3):
    """``train_fn(resume_step) -> final_step``; restarts on an exception
    from the latest checkpoint.  Returns (final_step, restarts_used)."""
    restarts = 0
    while True:
        try:
            resume = manager.latest_step()
            return train_fn(resume), restarts
        except (SystemExit, KeyboardInterrupt):
            raise
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise


class Heartbeat:
    def __init__(self, directory: str, host_id: int):
        self.dir = directory
        self.host_id = host_id
        os.makedirs(directory, exist_ok=True)

    def beat(self, step: int, t: Optional[float] = None):
        path = os.path.join(self.dir, f"host_{self.host_id}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": t or time.time()}, f)
        os.replace(tmp, path)

    @staticmethod
    def stale_hosts(directory: str, timeout_s: float,
                    now: Optional[float] = None):
        now = now or time.time()
        stale = []
        for name in os.listdir(directory):
            if not name.startswith("host_") or name.endswith(".tmp"):
                continue
            with open(os.path.join(directory, name)) as f:
                info = json.load(f)
            if now - info["time"] > timeout_s:
                stale.append(int(name.split("_")[1].split(".")[0]))
        return sorted(stale)


class StragglerDetector:
    """Flag hosts whose last step time exceeds median + k·MAD of the
    cohort."""

    def __init__(self, k: float = 4.0, min_samples: int = 5):
        self.k = k
        self.min_samples = min_samples
        self.times: dict[int, list[float]] = {}

    def record(self, host_id: int, step_time: float):
        self.times.setdefault(host_id, []).append(step_time)

    def stragglers(self):
        lasts = {h: ts[-1] for h, ts in self.times.items() if ts}
        if len(lasts) < self.min_samples:
            return []
        vals = np.array(list(lasts.values()))
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-9
        return sorted(h for h, t in lasts.items()
                      if t > med + self.k * mad)
