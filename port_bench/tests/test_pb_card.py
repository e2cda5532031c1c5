"""On the card: each cell runs end to end through the command, briefly,
and prints a correct result line of the expected shape. Run with
``python -m pytest -m cuda port_bench/tests``; skipped without a card."""

import json
import subprocess
import sys

import pytest
import torch

from port_bench import harness

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell, trace):
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell, "--seed", str(2 ** 31 + 99),
                           "--seconds", "3", "--trace", str(trace)], capture_output=True, text=True,
                          cwd=harness.ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert result["device"]["busy_s"] > 0 and len(result["breakdown"]["device_ops"]) <= 10
