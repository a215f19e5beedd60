"""Online hardness calibration: learn admission cost from observed solves.

Reference: ``repro/serve/calibration.py`` (``HardnessCalibrator``), copied:
it is numpy only, and the port imports nothing of the reference.

`repro_torch.serve.engine.GWEngine.predicted_hardness` starts from a
hand-tuned formula (annealing stages + log ε + a size term).  Those static
terms are a prior, not a measurement, and the engine has the measurement:
every harvested request reports how many outer iterations its solve ran.
This module closes the loop with per-bucket online ridge regression from
admission-time features onto observed outer-iteration counts.

Features (assembled by the engine, see ``_hardness_features``): a bias
term, the sliced-GW estimate (`repro_torch.core.sliced`) with a presence
flag, the ε-annealing stage count, and the log problem size.
Observations accumulate as sufficient statistics (A ← A + φφᵀ,
b ← b + φ·y), so ``observe`` is O(d²) and ``predict`` solves one (d, d)
system.

Keyed per BUCKET (the engine's geometry-spec key).  ``predict`` returns
None until a bucket has seen ``min_obs`` observations, and the engine then
uses its formula.  Predictions are clamped to ≥ 0.
"""
from __future__ import annotations

import numpy as np


class HardnessCalibrator:
    """Per-bucket online ridge regression φ → observed outer iterations."""

    def __init__(self, dim: int, min_obs: int = 12, ridge: float = 1.0):
        if dim <= 0:
            raise ValueError(f"feature dim must be positive, got {dim}")
        if min_obs < 1:
            raise ValueError(f"min_obs must be >= 1, got {min_obs}")
        self.dim = int(dim)
        self.min_obs = int(min_obs)
        self.ridge = float(ridge)
        # key -> [A (d,d), b (d,), count]
        self._stats: dict = {}
        self.observations = 0

    def _check(self, phi) -> np.ndarray:
        phi = np.asarray(phi, np.float64).ravel()
        if phi.shape != (self.dim,):
            raise ValueError(
                f"feature vector shape {phi.shape} != ({self.dim},)")
        return phi

    def observe(self, key, phi, outer: float) -> None:
        """Fold one harvested solve into the bucket's statistics.  Non-
        finite features/targets are dropped (a NaN observation would poison
        the bucket's normal equations forever)."""
        phi = self._check(phi)
        y = float(outer)
        if not (np.all(np.isfinite(phi)) and np.isfinite(y)):
            return
        st = self._stats.get(key)
        if st is None:
            st = [np.zeros((self.dim, self.dim)), np.zeros(self.dim), 0]
            self._stats[key] = st
        st[0] += np.outer(phi, phi)
        st[1] += phi * y
        st[2] += 1
        self.observations += 1

    def n_obs(self, key) -> int:
        st = self._stats.get(key)
        return 0 if st is None else st[2]

    def predict(self, key, phi) -> float | None:
        """Calibrated hardness for a request with features ``phi``, or None
        while the bucket is below ``min_obs`` (caller falls back to its
        prior formula)."""
        phi = self._check(phi)
        st = self._stats.get(key)
        if st is None or st[2] < self.min_obs:
            return None
        a = st[0] + self.ridge * np.eye(self.dim)
        try:
            w = np.linalg.solve(a, st[1])
        except np.linalg.LinAlgError:   # pragma: no cover - ridge guards
            return None
        return float(max(phi @ w, 0.0))
