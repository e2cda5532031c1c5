"""Published MoGe-1 and MoGe-2 architecture presets, as plain config dicts.

The same schema and values as ``moge_tpu.models.presets`` (the checkpoints'
``model_config``), kept here so the port builds models with no import from
the JAX package. A test holds the two tables equal.
"""

from __future__ import annotations

import copy
from typing import Any, Dict


def _v2_config(backbone: str, dim: int, layers, dim_feat: int, with_normal: bool = True) -> Dict[str, Any]:
    heads_common = {
        "dim_in": [dim_feat, 256, 128, 64, 32],
        "dim_res_blocks": [dim_feat, 256, 128, 64, 32],
        "num_res_blocks": [0, 1, 1, 1, 0],
        "res_block_in_norm": "none",
        "res_block_hidden_norm": "none",
        "resamplers": ["conv_transpose", "conv_transpose", "conv_transpose", "bilinear"],
    }
    cfg: Dict[str, Any] = {
        "encoder": {"backbone": backbone, "intermediate_layers": layers, "dim_out": dim_feat},
        "neck": {
            "dim_in": [dim_feat + 2, 2, 2, 2, 2],
            "dim_out": None,
            "dim_res_blocks": [dim_feat, 256, 128, 64, 32],
            "num_res_blocks": [0, 2, 2, 2, 0],
            "res_block_in_norm": "none",
            "res_block_hidden_norm": "none",
            "resamplers": ["conv_transpose", "conv_transpose", "conv_transpose", "bilinear"],
        },
        "points_head": {**copy.deepcopy(heads_common), "dim_out": [None, None, None, None, 3]},
        "mask_head": {**copy.deepcopy(heads_common), "dim_out": [None, None, None, None, 1]},
        "scale_head": {"dims": [dim, 1024, 1024, 1]},
        "remap_output": "exp",
        "num_tokens_range": [1200, 3600],
    }
    if with_normal:
        cfg["normal_head"] = {**copy.deepcopy(heads_common), "dim_out": [None, None, None, None, 3]}
    return cfg


MODEL_PRESETS: Dict[str, Dict[str, Any]] = {
    "moge-2-vitl": {"version": "v2", "config": _v2_config("dinov2_vitl14", 1024, [5, 11, 17, 23], 1024, with_normal=False)},
    "moge-2-vitl-normal": {"version": "v2", "config": _v2_config("dinov2_vitl14", 1024, [5, 11, 17, 23], 1024)},
    "moge-2-vitb-normal": {"version": "v2", "config": _v2_config("dinov2_vitb14", 768, [2, 5, 8, 11], 768)},
    "moge-2-vits-normal": {"version": "v2", "config": _v2_config("dinov2_vits14", 384, [2, 5, 8, 11], 384)},
    # MoGe-1 (the published Ruicheng/moge-vitl checkpoint's model_config)
    "moge-vitl": {
        "version": "v1",
        "config": {
            "encoder": "dinov2_vitl14",
            "intermediate_layers": 4,
            "dim_proj": 512,
            "dim_upsample": [256, 128, 64],
            "dim_times_res_block_hidden": 2,
            "num_res_blocks": 2,
            "remap_output": "exp",
            "res_block_norm": "layer_norm",
            "num_tokens_range": [1200, 2500],
            "last_res_blocks": 0,
            "last_conv_channels": 32,
            "last_conv_size": 1,
        },
    },
}


def get_preset(name: str) -> Dict[str, Any]:
    key = name.split("/")[-1].lower()
    if key not in MODEL_PRESETS:
        raise KeyError(f"Unknown model preset: {name} (known: {sorted(MODEL_PRESETS)})")
    return copy.deepcopy(MODEL_PRESETS[key])
