"""Serving, ported from ``repro.serve``.

  engine       — Engine and ServeConfig (LM prefill + decode); GWEngine
                 (barrier, continuous and pipeline schedulers, plan cache,
                 sliced tier), GWServeConfig, run_event_loop
  cache        — Fingerprint, fingerprint, PlanCache
  calibration  — HardnessCalibrator
"""
from repro_torch.serve import cache, calibration, engine
from repro_torch.serve.cache import Fingerprint, PlanCache, fingerprint
from repro_torch.serve.calibration import HardnessCalibrator
from repro_torch.serve.engine import (Engine, GWEngine, GWServeConfig,
                                      ServeConfig, run_event_loop)

__all__ = ["cache", "calibration", "engine", "Fingerprint", "PlanCache",
           "fingerprint", "HardnessCalibrator", "Engine", "ServeConfig",
           "GWEngine", "GWServeConfig", "run_event_loop"]
