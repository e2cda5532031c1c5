"""BENCHMARK.json keeps to its required format, and the harness finds
every cell, configuration, driver and metric by name."""

import json
import re

import pytest

from port_bench import harness
from moge_tpu_torch.models import presets

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_entries_have_the_required_keys_and_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("port_bench/") and (harness.ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in E2E
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in E2E


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_found_and_reports_its_metrics(cell):
    bench, workload, config = harness.load_cell(harness.ROOT, cell)
    assert (harness.HERE / "drivers" / f"{workload['kind']}.py").is_file()
    e2e = [m["name"] for m in harness.cell_metrics(bench, cell, False)]
    layer = harness.cell_metrics(bench, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])
    for m in harness.cell_metrics(bench, cell, False) + layer:
        reader = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py", "pb_metric")
        assert callable(reader.read)
    assert set(workload["limits"]) <= {"focal_rel", "depth_err", "depth_shift_rel", "normal_deg"}


def test_every_metric_file_is_named_in_the_benchmark():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.name[:-3] for p in (harness.HERE / "metrics").glob("*.py")}
    assert files == names


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files_hold_the_published_config_as_run(entry):
    config = json.loads((harness.ROOT / entry["file"]).read_text())
    preset = presets.get_preset(entry["name"])
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"] == [] and config["assumed"] == []
    assert config["version"] == preset["version"] and config["model_config"] == preset["config"]
    assert config["dtype"] in ("bfloat16", "float32")
