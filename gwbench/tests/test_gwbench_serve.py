"""The serving mix: every seed serves the same requests in the same order,
and the seed chooses only which answers are checked, one in each stretch
of the window for every ε class."""
import types

import pytest
import torch

from gwbench.drivers import serve
from gwbench.tests import _small

NAME = "grid1d-log.serve-1k2k"


def _driver(seed: int) -> serve.Driver:
    return serve.Driver(_small.cell(NAME), seed, _small.CPU)


def test_stream_does_not_depend_on_the_seed():
    a, b = _driver(2 ** 31 + 1), _driver(2 ** 32 + 7)
    a.setup()
    b.setup()
    for i in range(2 * a.bank_size + 3):
        (gx, gy, mu, nu), knobs = a._request(i)
        (hx, hy, mv, nv), other = b._request(i)
        assert (gx.n, gy.n, knobs) == (hx.n, hy.n, other)
        assert bool((mu == mv).all()) and bool((nu == nv).all())


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 32 + 11])
def test_check_times_fill_every_stretch(seed):
    d = _driver(seed)
    per = int(d.cell.traffic["check"]["per_class"])
    assert set(d.targets) == set(d.cycle)
    for times in d.targets.values():
        assert [int(t * per) for t in times] == list(range(per))
    assert _driver(seed).targets == d.targets
    assert _driver(seed + 1).targets != d.targets


def test_checked_answers_span_the_window():
    # answers as `serve` would yield them, four of each class in every
    # tenth of the window and a drain after it
    d = _driver(2 ** 31 + 9)
    d.setup()
    per = int(d.cell.traffic["check"]["per_class"])
    plan = torch.full((d.lo, d.lo), 1.0 / d.lo ** 2)
    info = types.SimpleNamespace(outer_iters=3, inner_iters=30)
    i = 0
    for tenth in range(12):
        for _ in range(4 * len(d.cycle)):
            at = (tenth + (i % 7) / 7) / 10
            d._keep(i, at, types.SimpleNamespace(plan=plan, value=1.0,
                                                 info=info))
            i += 1
    for eps in d.cycle:
        ats = sorted(k[-1] for j, k in d.kept.items() if d._eps(j) == eps)
        assert len(ats) == per
        assert [min(int(a * per), per - 1) for a in ats] == list(range(per))


def test_a_run_compares_the_plans():
    out = _small.run_small(NAME)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"plan_l1_max", "value_rel_max",
                                  "plan_energy_rel_max"}
