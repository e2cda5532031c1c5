"""Weight bridge from the JAX package's parameter tree to this port.

``state_dict_from_jax_params`` writes the microsoft/MoGe state-dict layout
with ``moge_tpu.models.convert.export_moge2`` (numpy-only; imported inside
the function) and returns torch tensors that ``MoGeV2.load_state_dict(...,
strict=True)`` takes without renames. Tests use it so that both packages
compute with the same weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_jax_params"]


def state_dict_from_jax_params(config: Mapping[str, Any], params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX MoGe-2 params (a nested dict of arrays in the unrolled
    ``blocks_{i}`` layout, or the stacked one) -> torch state dict."""
    from moge_tpu.models.convert import export_moge2

    sd = export_moge2(config, params)["model"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
