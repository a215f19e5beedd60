"""The train step: `repro_torch.train.loop.train_step` against the
reference's ``train.loop.train_step`` (under ``jax.jit``) on the CPU, from
one state (`convert.train_state`), at smoke widths in f32, for every
architecture.  Inputs, configs and bars: tests/_torch_train.py.
"""
import numpy as np
import pytest

from _torch_train import F32, STEP_TCFG, XLSTM_F32, _batch, _check_step, _run
from repro import configs as ref_configs
from repro_torch import configs


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_train_step_matches_reference(arch):
    """Every architecture, 2 microbatches of 2 × 16 (the smoke train step
    of tests/test_models.py:42)."""
    cfg = ref_configs.get_smoke(arch)
    new, metrics, port, port_metrics, _ = _run(
        arch, STEP_TCFG, _batch(cfg, 4, 16, ("step", arch)))
    _check_step(new, metrics, port, port_metrics,
                XLSTM_F32 if arch == "xlstm-350m" else F32)
    assert np.isfinite(float(port_metrics["loss"]))
