"""Weight bridge from the JAX package's parameter trees to this port.

``state_dict_from_jax_params`` (MoGe-2) and ``v1_state_dict_from_jax_params``
(MoGe-1) write the microsoft/MoGe state-dict layout with
``moge_tpu.models.convert.export_moge2`` / ``export_moge1`` (numpy-only;
imported inside the functions) and return torch tensors that the port's
``load_state_dict(..., strict=True)`` takes without renames. Tests use them
so that both packages compute with the same weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_jax_params", "v1_state_dict_from_jax_params"]


def _to_torch(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def state_dict_from_jax_params(config: Mapping[str, Any], params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX MoGe-2 params (a nested dict of arrays in the unrolled
    ``blocks_{i}`` layout, or the stacked one) -> torch state dict."""
    from moge_tpu.models.convert import export_moge2

    return _to_torch(export_moge2(config, params)["model"])


def v1_state_dict_from_jax_params(config: Mapping[str, Any], params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX MoGe-1 params (unrolled ``blocks_{i}`` layout) -> torch state dict."""
    from moge_tpu.models.convert import export_moge1

    return _to_torch(export_moge1(config, params)["model"])
