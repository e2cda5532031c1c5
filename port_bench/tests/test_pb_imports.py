"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name (the port's ``moge_tpu_torch`` begins with the JAX
package's name); the reference imports nothing of the program; a run
without a CUDA card fails and prints no result."""

import ast
import os
import subprocess
import sys

import pytest

from port_bench import harness

SOURCES = sorted(harness.HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "moge_tpu"}


def _roots(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_roots(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not set(_roots(path)) & {"moge_tpu_torch", "port_bench"}


def test_a_run_loads_no_jax_module():
    code = (f"import sys; sys.path.insert(0, {str(harness.ROOT)!r})\n"
            "from port_bench import harness, compare, weights, program, trace, readers, roofline\n"
            "for kind in ('serve', 'offline'):\n"
            "    harness.load_module(harness.HERE / 'drivers' / f'{kind}.py', kind)\n"
            "import moge_tpu_torch.models.v1, moge_tpu_torch.models.v2, moge_tpu_torch.scripts.serve\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "moge_tpu_torch_like", sys)
    assert "moge_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "moge_tpu", sys)
    assert harness.forbidden_modules() == ["moge_tpu"]


def test_without_a_card_a_run_fails_and_prints_no_result():
    proc = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", "v2l-offline-b8-3600",
                           "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=harness.ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
