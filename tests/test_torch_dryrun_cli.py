"""The production dry run (`repro_torch.launch.dryrun`) on the production
meshes and through its CLI, on the CPU: a smoke cell on the 2×16×16 mesh
(a fake group of 512 ranks), xLSTM's full-width ``long_500k`` cell on the
16×16 mesh (256 ranks) through ``main``, the reference's skip, and no
quiet CPU run without a card.  The rest of the dry run's tests:
`tests/test_torch_dryrun.py`.
"""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_threads import one_torch_thread  # noqa: F401
from repro import configs as ref_configs
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun, flops


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized()


def test_multi_pod_mesh():
    """A smoke decode cell on the 2×16×16 production mesh, a fake group of
    512 ranks (the CLI test runs the 16×16 one)."""
    shape = ShapeSpec("tiny_decode", "decode", 16, 32)
    rec = dryrun.run_cell("smollm-360m", shape.name, True, verbose=False,
                          device="cpu", cfg=configs.get_smoke("smollm-360m"),
                          shape=shape)
    assert rec["mesh"] == "2x16x16" and rec["chips"] == 512
    mem = rec["memory_per_device"]
    assert mem["total_bytes"] >= mem["argument_bytes"] > 0
    assert rec["collectives"]["counts"]


def test_cli_writes_a_record(tmp_path):
    """xLSTM's decode against a 524 288-token state is one token: the
    full-width cell on the 16×16 mesh, through the CLI."""
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--device", "cpu", "--arch", "xlstm-350m",
                        "--shape", "long_500k", "--mesh", "single",
                        "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert len(recs) == 1
    rec = recs[0]
    assert "error" not in rec and "skipped" not in rec
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["params_total"] == sum(
        int(np.prod(s)) for s in flops.meta_shapes(
            configs.get("xlstm-350m")).values())


def test_cli_skips_what_the_reference_skips(tmp_path):
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--device", "cpu", "--arch", "smollm-360m",
                        "--shape", "long_500k", "--mesh", "single",
                        "--out", str(out)]) == 0
    (rec,) = json.loads(out.read_text())
    want = ref_configs.applicable(ref_configs.get("smollm-360m"),
                                  REF_SHAPES["long_500k"])[1]
    assert rec["skipped"] == want


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA device"):
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--mesh", "single", "--out", str(tmp_path / "d.json")])
