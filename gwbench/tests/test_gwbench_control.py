"""The lower-precision control comes out not correct.

The configured controls (``control.variant`` of each configuration: the
program reading the cost as bfloat16, or the reference with TF32 products
in the program's place) exist only on the card and are measured there at
the cells' own sizes by ``gwbench/readings.py --control``; here they run at
a small size on a card when there is one.  On the CPU, where neither path
exists, the reference computed in bfloat16 in the program's place stands
for them: the comparison has to reject it as well.
"""
import pytest
import torch

from gwbench import readings
from gwbench.tests import _small

SOLVES = [c for c in _small.CELLS if "solve" in c]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the configured controls run on a CUDA card only")
    return torch.device("cuda")


@pytest.mark.parametrize("name", SOLVES)
def test_reference_in_bfloat16_is_not_correct(name):
    out = _small.run_small(name, variant={"reference": "bfloat16"})
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _small.CELLS)
def test_configured_control_is_not_correct(card, name):
    cell = _small.cell(name)
    recs = readings.readings(name, [2 ** 31 + 11], 1.5, True, card,
                             cell=cell)
    assert not recs[0]["correct"], recs[0]["checks"]
