"""The harness drives a whole run of each cell on the CPU at a small size
(no look for a card), and ``correct`` comes out true for the program as it
is and false with the timed path broken underneath, once for each fault a
cell can have:

* a mirror step that returns its state unchanged;
* half of the batch left out: in a solve, half of the plan's rows left out
  of the gradient's product and the rest doubled (the mean taken over the
  rest); in serving, half of a batch's lanes never advanced;
* an answer altered where it is produced (its value and plan shifted).

The exchange between chips cannot be left out: every cell runs on one.
"""
import dataclasses

import pytest
import torch

from gwbench.tests import _small
from repro_torch.core import gradient, gw
from repro_torch.serve import engine


@pytest.mark.parametrize("name", _small.CELLS)
def test_sound_run_is_correct(name):
    out = _small.run_small(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


def _unchanged(monkeypatch):
    real = gw.gw_step_fn

    def step_fn(*args, **kw):
        step = real(*args, **kw)

        def frozen(state, eps, inner_tol):
            _, err, used = step(state, eps, inner_tol)
            return state, err, used
        return frozen
    monkeypatch.setattr(gw, "gw_step_fn", step_fn)


def _half_rows(monkeypatch):
    real = gradient.GradientOperator.product

    def product(self, gamma):
        rows = gamma.shape[-2]
        kept = gamma.clone()
        kept[..., rows // 2:, :] = 0.0
        return real(self, 2.0 * kept)
    monkeypatch.setattr(gradient.GradientOperator, "product", product)


def _half_lanes(monkeypatch):
    real = gw.gw_step_fn

    def step_fn(*args, **kw):
        step = real(*args, **kw)

        def half(state, eps, inner_tol):
            new, err, used = step(state, eps, inner_tol)
            lanes = new.plan.shape[0]
            live = torch.arange(lanes, device=new.plan.device) < \
                max(lanes // 2, 1)
            return new.select(live, state), err, used
        return half
    monkeypatch.setattr(gw, "gw_step_fn", step_fn)


def _altered(monkeypatch):
    real = gw._result_of

    def result_of(coupling, value, info):
        res = real(coupling, value, info)
        plan = torch.roll(res.plan, 1, dims=-1)
        return dataclasses.replace(res, plan=plan, value=res.value * 1.01)
    monkeypatch.setattr(gw, "_result_of", result_of)
    monkeypatch.setattr(engine, "_result_of", result_of)


SOLVE_FAULTS = {"unchanged": _unchanged, "half_rows": _half_rows,
                "altered": _altered}
SERVE_FAULTS = {"unchanged": _unchanged, "half_lanes": _half_lanes,
                "altered": _altered}
CASES = ([(c, f) for c in _small.CELLS if "solve" in c
          for f in SOLVE_FAULTS]
         + [(c, f) for c in _small.CELLS if "serve" in c
            for f in SERVE_FAULTS])


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(monkeypatch, name, fault):
    faults = SERVE_FAULTS if "serve" in name else SOLVE_FAULTS
    faults[fault](monkeypatch)
    out = _small.run_small(name)
    assert not out["correct"], out["checks"]
