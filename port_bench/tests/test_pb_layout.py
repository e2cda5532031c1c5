"""BENCHMARK.json keeps to its required format, the harness finds every
cell, configuration, driver and metric by name, and each configuration file
holds the published configuration it runs, or states what it changed."""

import json
import re
from pathlib import Path
from typing import List

import pytest

from port_bench import harness
from port_bench.tests import tiny
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


def _differences(a, b, key: str = "") -> List[str]:
    """The keys at which two configurations differ, down to their leaves
    (``encoder.backbone``, ``scale_head.dims[0]``); lists of one length
    element by element."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b)):
            sub = f"{key}.{k}" if key else k
            out += _differences(a[k], b[k], sub) if k in a and k in b else [sub]
        return out
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _differences(x, y, f"{key}[{i}]")]
    return [] if a == b else [key]


def _covers(key: str, difference: str) -> bool:
    return difference == key or difference.startswith((key + ".", key + "["))


def configuration_faults(path: Path) -> List[str]:
    """What keeps a configuration file from stating the published
    configuration it runs. A file named after a preset holds it whole, with
    ``reduced`` and ``assumed`` empty. Any other names its base preset under
    ``derived_from`` and lists under ``assumed``, as ``{"key", "from"}``,
    exactly the keys of ``model_config`` in which it differs from that base:
    each difference under a listed key, and each listed key differing."""
    config = json.loads(path.read_text())
    name, assumed = config["name"], config["assumed"]
    if name in presets.MODEL_PRESETS:
        if assumed or config["reduced"] or "derived_from" in config:
            return [f"{name} is a preset: it is held whole, nothing reduced, assumed or derived"]
        base_name = name
    elif config.get("derived_from") in presets.MODEL_PRESETS:
        base_name = config["derived_from"]
    else:
        return [f"{name} is no preset and names none under derived_from"]
    base = presets.get_preset(base_name)
    faults = [] if config["version"] == base["version"] else ["version"]
    faults += [f"assumed entry {a} is not a key with where its value comes from" for a in assumed
               if set(a) != {"key", "from"} or not a["from"]]
    keys = [a.get("key", "") for a in assumed]
    differences = _differences(base["config"], config["model_config"])
    faults += [f"{d} differs from {base_name} and is not listed" for d in differences
               if not any(_covers(k, d) for k in keys)]
    return faults + [f"{k} is listed but does not differ" for k in keys if not any(_covers(k, d) for d in differences)]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files_hold_the_published_config_as_run(entry):
    config = json.loads((harness.ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert configuration_faults(harness.ROOT / entry["file"]) == []
    assert config["dtype"] in ("bfloat16", "float32")


def _unlisted_change(c):
    c["model_config"]["neck"]["dim_in"][0] = 1538


def _idle_listing(c):
    c["assumed"].append({"key": "neck.dim_out", "from": "nowhere"})


def _listing_without_source(c):
    c["assumed"][0] = {"key": c["assumed"][0]["key"]}


def _preset_with_assumed(c):
    c.update(name=c.pop("derived_from"))


def _unknown_base(c):
    c["derived_from"] = "moge-2-vitg"


@pytest.mark.parametrize("alter,faults", [
    (lambda c: None, 0), (_unlisted_change, 1), (_idle_listing, 1), (_listing_without_source, 1),
    (_preset_with_assumed, 1), (_unknown_base, 1),
], ids=["lists_its_changes", "unlisted_change", "idle_listing", "listing_without_source", "preset_with_assumed",
        "unknown_base"])
def test_a_derived_configuration_states_exactly_its_changes(alter, faults, tmp_path):
    """The giant's file, derived from moge-2-vitl-normal, passes as written
    and fails with each fault planted."""
    config = tiny.giant_file()
    alter(config)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    assert len(configuration_faults(path)) == faults, configuration_faults(path)
