"""Weight grafts from other layouts into the port's modules (the part of
moge_tpu/models/convert.py the port needs).

``load_dinov2_backbone`` puts a DINOv2 hub checkpoint (``dinov2_vit*14_pretrain.pth``,
or a full SSL-training checkpoint holding one under ``teacher`` or
``model``) into a ``DinoVisionTransformer``: the port's backbone uses the
hub's parameter names, so the graft is a strict ``load_state_dict`` after
the unwrapping, with a clear error when the file is another architecture.
"""

from __future__ import annotations

from typing import Any, Dict

from torch import nn

__all__ = ["load_dinov2_backbone"]


def load_dinov2_backbone(module: nn.Module, sd: Dict[str, Any]) -> None:
    """Load a hub-layout DINOv2 state dict into ``module`` (the port's
    ``DinoVisionTransformer``) in place, after stripping a ``teacher``
    wrapper, then a ``model`` one whose keys are not already the blocks'
    (as the JAX train command does); ValueError naming the missing,
    unexpected and mis-shaped keys when it does not match."""
    if isinstance(sd, dict) and "teacher" in sd:
        sd = sd["teacher"]
    if isinstance(sd, dict) and "model" in sd and not any("blocks." in k for k in sd):
        sd = sd["model"]
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    shapes = sorted(f"{k}: {tuple(sd[k].shape)} vs {tuple(v.shape)}" for k, v in own.items()
                    if k in sd and tuple(sd[k].shape) != tuple(v.shape))
    if missing or unexpected or shapes:
        raise ValueError(f"backbone checkpoint does not match the configured architecture: {len(missing)} "
                         f"missing keys {missing[:4]}, {len(unexpected)} unexpected {unexpected[:4]}, "
                         f"{len(shapes)} of another shape {shapes[:4]}")
    module.load_state_dict(sd, strict=True)
