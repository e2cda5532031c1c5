"""The port stands alone: no module of moge_tpu_torch, and not chip_smoke.py,
imports JAX or the JAX package (moge_tpu), at any depth, inside functions
too; and its model entry points run on the card unless asked for the CPU."""

import ast
import inspect
from pathlib import Path

import pytest

from moge_tpu_torch.models import v1, v2

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "moge_tpu"}
SOURCES = sorted((ROOT / "moge_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    """(line, top-level module) of every absolute import in a source file."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from ((node.lineno, alias.name.split(".")[0]) for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [f"{path.relative_to(ROOT)}:{line} imports {root}" for line, root in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, bad


def test_the_guard_sees_nested_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\n\ndef f():\n    from moge_tpu.utils import io\n    import jax.numpy as jnp\n"
                   "    from moge_tpu_torch.ops import norm\n    from . import x\n")
    assert [root for _, root in _imported_roots(src)] == ["os", "moge_tpu", "jax", "moge_tpu_torch"]


@pytest.mark.parametrize("cls", [v1.MoGeModel, v2.MoGeModel], ids=["v1", "v2"])
def test_models_default_to_the_card(cls):
    assert inspect.signature(cls.__init__).parameters["device"].default == "cuda"
    assert inspect.signature(cls.from_pretrained).parameters["device"].default == "cuda"
