"""The port stands alone: no module of moge_tpu_torch, and not chip_smoke.py,
imports JAX or the JAX package (moge_tpu), at any depth, inside functions
too; none imports the host-only packages (cv2, PIL, click, matplotlib) when
it is imported, so the package loads where they are missing; and its model
entry points run on the card unless asked for the CPU."""

import ast
import inspect
from pathlib import Path

import pytest

from moge_tpu_torch.models import v1, v2

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "moge_tpu"}
HOST_ONLY = {"cv2", "PIL", "click", "matplotlib"}  # imported inside the functions that use them
SOURCES = sorted((ROOT / "moge_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _roots(node):
    if isinstance(node, ast.Import):
        yield from ((node.lineno, alias.name.split(".")[0]) for alias in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        yield node.lineno, node.module.split(".")[0]


def _imported_roots(path: Path):
    """(line, top-level module) of every absolute import in a source file."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        yield from _roots(node)


def _import_time_roots(path: Path):
    """(line, top-level module) of the absolute imports that run when the
    file is imported: every one outside a function body."""
    todo = list(ast.parse(path.read_text(), filename=str(path)).body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield from _roots(node)
        todo.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [f"{path.relative_to(ROOT)}:{line} imports {root}" for line, root in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_time_import_of_host_only_packages(path):
    bad = [f"{path.relative_to(ROOT)}:{line} imports {root} at import time"
           for line, root in _import_time_roots(path) if root in HOST_ONLY]
    assert not bad, bad


def test_the_host_only_guard_skips_function_bodies(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import numpy\nimport click\n\nclass A:\n    from PIL import Image\n\n"
                   "    def f(self):\n        import cv2\n\ndef g():\n    import matplotlib\n"
                   "try:\n    import cv2.ximgproc\nexcept ImportError:\n    pass\n")
    assert sorted(root for _, root in _import_time_roots(src)) == ["PIL", "click", "cv2", "numpy"]


def test_the_guard_sees_nested_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\n\ndef f():\n    from moge_tpu.utils import io\n    import jax.numpy as jnp\n"
                   "    from moge_tpu_torch.ops import norm\n    from . import x\n")
    assert [root for _, root in _imported_roots(src)] == ["os", "moge_tpu", "jax", "moge_tpu_torch"]


@pytest.mark.parametrize("cls", [v1.MoGeModel, v2.MoGeModel], ids=["v1", "v2"])
def test_models_default_to_the_card(cls):
    assert inspect.signature(cls.__init__).parameters["device"].default == "cuda"
    assert inspect.signature(cls.from_pretrained).parameters["device"].default == "cuda"


def test_the_guards_cover_the_parallel_modules():
    """The parallel layer (``moge_tpu_torch/parallel/``) is among the
    sources both guards parse, and imports neither JAX nor the JAX package."""
    parallel = {p.name for p in SOURCES if p.parent.name == "parallel"}
    assert parallel == {"__init__.py", "distributed.py", "mesh.py"}
    for path in SOURCES:
        if path.parent.name == "parallel":
            assert not {root for _, root in _imported_roots(path)} & FORBIDDEN, path


def test_the_train_command_defaults_to_the_card():
    """The training command's ``--device`` (and so its workers') defaults to cuda."""
    from moge_tpu_torch.scripts import train

    device = next(p for p in train.command().params if p.name == "device_name")
    assert device.default == "cuda"
