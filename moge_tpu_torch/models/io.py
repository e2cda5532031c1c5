"""Checkpoint loading for the port's models (port of moge_tpu/models/io.py).

``load_checkpoint`` reads a reference-format ``.pt`` file
(``{'model_config', 'model'}``, the microsoft/MoGe layout, which the port's
modules take with ``load_state_dict(strict=True)`` and no renames) with
``torch.load(weights_only=True)``. It serves both ``from_pretrained``s.
The JAX package's own Orbax checkpoint directories are not read here.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import torch

__all__ = ["load_checkpoint"]


def load_checkpoint(path, version: str = "v2") -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """A local MoGe checkpoint -> (model_config, state_dict) on the CPU."""
    if version not in ("v1", "v2"):
        raise ValueError(f"Unknown model version: {version}")
    p = Path(str(path))
    if p.is_dir():
        raise ValueError(f"{p} is a directory: the port reads reference .pt checkpoints, not the JAX "
                         "package's Orbax checkpoint directories")
    if not p.is_file():
        raise FileNotFoundError(f"no checkpoint at {p} (the port loads local .pt files; download a hub "
                                "checkpoint's model.pt first)")
    ckpt = torch.load(p, map_location="cpu", weights_only=True)
    return dict(ckpt["model_config"]), ckpt["model"]
