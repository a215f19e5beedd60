"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (`gwbench.reference`), number by number, each
against its limit (``limits/<cell>.json``)."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        # a NaN or an infinity fails: a control that gives no number has
        # failed
        return math.isfinite(self.value) and self.value <= self.limit

    def line(self) -> str:
        return (f"check {self.name}: {self.value!r} (limit {self.limit!r})"
                f" {'ok' if self.ok else 'FAILED'}")


def gaps(plan, value, sol) -> tuple[float, float]:
    """(plan L1 gap, relative value gap) of a program's answer against the
    reference's `Solution`: Σ|Γ − Γ_ref| (both plans carry mass 1, so it is
    a share of the mass) and |v − v_ref| / |v_ref|, in float64."""
    ref = sol.plan
    got = plan.to(ref.device, torch.float64)
    l1 = float((got - ref.to(torch.float64)).abs().sum())
    v = float(value)
    rel = abs(v - sol.value) / abs(sol.value)
    return l1, rel


def checks(limits: dict, readings: dict) -> list[Check]:
    """One `Check` a limit, in the limits file's order; a reading the run
    could not make reads as NaN and fails."""
    return [Check(name, float(readings.get(name, math.nan)), float(lim))
            for name, lim in limits["limits"].items()]
