"""Tiny MoGe-2 config shared by the port's tests (no JAX import, so GPU hosts
without JAX can use it): the full structure (encoder, neck, three heads,
scale MLP) on the ``dinov2_vitt14`` arch, as in
``__graft_entry__.dryrun_multichip``."""

_HEAD = {
    "dim_in": [64, 32, 16, 16, 16], "dim_res_blocks": [64, 32, 16, 16, 16], "num_res_blocks": [0, 1, 1, 1, 0],
    "res_block_in_norm": "none", "res_block_hidden_norm": "none",
    "resamplers": ["conv_transpose", "conv_transpose", "conv_transpose", "bilinear"],
}

TINY_CONFIG = {
    "encoder": {"backbone": "dinov2_vitt14", "intermediate_layers": [0, 1, 2, 3], "dim_out": 64},
    "neck": {
        "dim_in": [66, 2, 2, 2, 2], "dim_out": None,
        "dim_res_blocks": [64, 32, 16, 16, 16], "num_res_blocks": [0, 1, 1, 1, 0],
        "res_block_in_norm": "none", "res_block_hidden_norm": "none",
        "resamplers": ["conv_transpose", "conv_transpose", "conv_transpose", "bilinear"],
    },
    "points_head": {**_HEAD, "dim_out": [None, None, None, None, 3]},
    "normal_head": {**_HEAD, "dim_out": [None, None, None, None, 3]},
    "mask_head": {**_HEAD, "dim_out": [None, None, None, None, 1]},
    "scale_head": {"dims": [192, 64, 1]},
    "remap_output": "exp",
    "num_tokens_range": [1200, 3600],
}
