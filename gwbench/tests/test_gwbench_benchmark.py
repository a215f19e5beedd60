"""``BENCHMARK.json`` is whole: every name well formed, and every file a
cell or a metric is found by present under ``gwbench/``."""
import json
import re

import pytest

from gwbench import run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    assert 1 <= BENCH["run_seconds"] <= 51
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry, resolved = run.resolve(BENCH, cell)
    assert resolved.config["name"] == entry["config"]
    assert resolved.traffic["driver"] in ("closed_solve", "serve")
    assert resolved.limits["limits"]
    e2e = [m["name"] for m in run.metrics_for(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.metrics_for(BENCH, cell, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert (run.HERE / "metrics" / f"{metric}.py").is_file()
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert set(m.get("workloads", [])) <= set(CELLS)


def test_configs_are_gwconfigs():
    from repro_torch.core import GWConfig
    for c in BENCH["configs"]:
        conf = json.loads((run.ROOT / c["file"]).read_text())
        GWConfig(**conf["solver"])
        assert set(conf["control"]["variant"]) <= {"solver", "reference"}
