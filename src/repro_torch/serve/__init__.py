"""GW serving, ported from ``repro.serve``.

  engine       — GWEngine (barrier, continuous and pipeline schedulers,
                 plan cache, sliced tier), GWServeConfig, run_event_loop
  cache        — Fingerprint, fingerprint, PlanCache
  calibration  — HardnessCalibrator

The reference's LM ``Engine`` comes with the LM substrate.
"""
from repro_torch.serve import cache, calibration, engine
from repro_torch.serve.cache import Fingerprint, PlanCache, fingerprint
from repro_torch.serve.calibration import HardnessCalibrator
from repro_torch.serve.engine import GWEngine, GWServeConfig, run_event_loop

__all__ = ["cache", "calibration", "engine", "Fingerprint", "PlanCache",
           "fingerprint", "HardnessCalibrator", "GWEngine", "GWServeConfig",
           "run_event_loop"]
