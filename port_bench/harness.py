"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell and the metrics it reports, ``workloads/<cell>.json`` its traffic and
limits, ``configs/<config>.json`` the model, ``drivers/<kind>.py`` the
traffic driver and ``metrics/<metric>.py`` each metric's reader. A driver
has ``setup(ctx) -> state``, ``window(state, seconds, traced) -> records``,
``answers(state) -> found`` (what its check reads; it then drops the
program's state) and ``check(ctx, found) -> checks``, each number it
compares as ``{"value": ..., "limit": ...}``; the harness only judges them.
A reader has ``read(run) -> float | None``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "moge_tpu")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict[str, Any], cell: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics a cell reports: its end-to-end ones untraced, its
    per-layer ones traced (a metric without ``workloads`` in every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def load_cell(root: Path, cell: str):
    """(BENCHMARK.json, the cell's file, its configuration's file)."""
    bench = load_json(root / "BENCHMARK.json")
    if not any(w["name"] == cell for w in bench["workloads"]):
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    workload = load_json(HERE / "workloads" / f"{cell}.json")
    config = load_json(HERE / "configs" / f"{workload['config']}.json")
    return bench, workload, config


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def run(args, t0: float) -> int:
    """The command: refuse without the card the cell asks for, run the
    cell, print the result line and the checks; the exit code."""
    import torch

    bench, workload, config = load_cell(ROOT, args.workload)
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA device(s); torch sees {seen}", file=sys.stderr)
        return 2
    result = execute(bench, args.workload, workload, config, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), t0)
    found = forbidden_modules()
    if found:
        print(f"loaded once the window had closed: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    return 0


def execute(bench, cell: str, workload, config, seed: int, seconds: float, traced: bool, device, t0: float,
            int8: bool = False) -> Dict[str, Any]:
    """Set-up, window, check and metrics of one run: the result line's object."""
    import torch

    driver = load_module(HERE / "drivers" / f"{workload['kind']}.py", f"pb_driver_{workload['kind']}")
    ctx = SimpleNamespace(workload=workload, config=config, seed=seed, seconds=seconds, device=device, int8=int8,
                          traced=traced)
    state = driver.setup(ctx)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    records = driver.window(state, seconds, traced)
    torch.cuda.synchronize()
    window_peak = torch.cuda.max_memory_allocated()
    process_peak = max(window_peak, state.setup_peak)
    if records.get("late_p95_ms") is not None:
        print(f"generator late p95 {records['late_p95_ms']} ms, max {records['late_max_ms']} ms", file=sys.stderr)

    found = driver.answers(state)
    state = None
    gc.collect()
    torch.cuda.empty_cache()
    checks = driver.check(ctx, found)
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())

    run_ = SimpleNamespace(setup_s=setup_s, records=records, workload=workload, config=config,
                           window_peak=window_peak, trace=records.get("trace"))
    metrics = {}
    for m in cell_metrics(bench, cell, traced):
        value = load_module(HERE / "metrics" / f"{m['name']}.py", "pb_metric").read(run_)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result: Dict[str, Any] = {
        "correct": correct, "attempted": records["attempted"], "failed": records["failed"], "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu", "count": 1,
                   "memory_peak_bytes": process_peak}}
    if traced and run_.trace is not None:
        result["device"]["busy_s"] = run_.trace["busy_s"]
        result["device"]["window_s"] = run_.trace["window_s"]
        result["breakdown"] = run_.trace["breakdown"]
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]} for k, v in checks.items()}
    return result

