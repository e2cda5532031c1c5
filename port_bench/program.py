"""The system under test: the program's models, built from the benchmark's
configuration and loaded with the benchmark's weights (strictly, by the
checkpoint's names). The only module of the benchmark that builds a model
of the program."""

from __future__ import annotations

from typing import Any, Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build(config: Dict[str, Any], state_dict: Dict[str, torch.Tensor], device, int8: bool = False):
    """The program's ``MoGeModel`` of ``config`` on ``device``, in its dtype,
    with ``state_dict`` loaded; ``int8`` builds MoGe-2's W8A8 int8 encoder."""
    if config["version"] == "v2":
        from moge_tpu_torch.models.v2 import MoGeModel

        model = MoGeModel(config["model_config"], device=device, dtype=torch.bfloat16, use_int8=int8)
    else:
        if int8:
            raise ValueError("the program has no int8 MoGe-1")
        from moge_tpu_torch.models.v1 import MoGeModel

        model = MoGeModel(config["model_config"], device=device, dtype=torch.bfloat16)
    model.module.load_state_dict(state_dict, strict=True)
    return model


def use_fp16(config: Dict[str, Any]) -> bool:
    """``infer``'s ``use_fp16`` for the configuration's compute dtype."""
    return config["dtype"] == "bfloat16"
