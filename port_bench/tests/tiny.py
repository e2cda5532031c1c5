"""Tiny configurations and a CPU stand-in for the card, shared by the
benchmark's CPU tests: the benchmark's cells cut to sizes that a test
run holds, the program on its plain CPU versions."""

from __future__ import annotations

import copy
import time

import torch

from port_bench import harness

_HEAD = {"dim_in": [64, 32, 16, 16, 16], "dim_res_blocks": [64, 32, 16, 16, 16], "num_res_blocks": [0, 1, 1, 1, 0],
         "res_block_in_norm": "none", "res_block_hidden_norm": "none",
         "resamplers": ["conv_transpose", "conv_transpose", "conv_transpose", "bilinear"]}
V2 = {
    "encoder": {"backbone": "dinov2_vitt14", "intermediate_layers": [0, 1, 2, 3], "dim_out": 64},
    "neck": {"dim_in": [66, 2, 2, 2, 2], "dim_out": None, "dim_res_blocks": [64, 32, 16, 16, 16],
             "num_res_blocks": [0, 1, 1, 1, 0], "res_block_in_norm": "none", "res_block_hidden_norm": "none",
             "resamplers": ["conv_transpose", "conv_transpose", "conv_transpose", "bilinear"]},
    "points_head": {**_HEAD, "dim_out": [None, None, None, None, 3]},
    "normal_head": {**_HEAD, "dim_out": [None, None, None, None, 3]},
    "mask_head": {**_HEAD, "dim_out": [None, None, None, None, 1]},
    "scale_head": {"dims": [192, 64, 1]},
    "remap_output": "exp",
    "num_tokens_range": [16, 36],
}


def giant_file() -> dict:
    """MoGe-2 with the normal head on DINOv2 ViT-g/14 (40 blocks of 1536, 24
    heads, the fused SwiGLU) as a configuration file derived from the preset
    ``moge-2-vitl-normal``, with its weights, at the published widths."""
    base = harness.load_json(harness.HERE / "configs" / "moge-2-vitl-normal.json")
    model = copy.deepcopy(base["model_config"])
    model["encoder"].update(backbone="dinov2_vitg14", intermediate_layers=[9, 19, 29, 39])
    model["scale_head"]["dims"][0] = 1536
    return {"name": "moge-2-vitg14-normal", "version": "v2", "dtype": "bfloat16", "derived_from": base["name"],
            "source": "https://github.com/facebookresearch/dinov2", "reduced": [],
            "assumed": [
                {"key": "encoder.backbone",
                 "from": "facebookresearch/dinov2 hubconf.py: dinov2_vitg14, vit_giant2 with ffn_layer swiglufused"},
                {"key": "encoder.intermediate_layers",
                 "from": "facebookresearch/dinov2 hub/depthers.py: the layers its heads take of vit_giant2"},
                {"key": "scale_head.dims[0]",
                 "from": "the width of the giant's cls token, which the scale head reads"}],
            "note": "MoGe-2 ViT-L normal's neck and heads on the DINOv2 giant, whole: 40 blocks, bf16.",
            "model_config": model, "weights": copy.deepcopy(base["weights"])}


def swiglu(monkeypatch) -> None:
    """The tiny test arch with DINOv2's fused SwiGLU feed-forward in place of
    its MLP, in the program's table and in the reference's alike."""
    import dataclasses

    from moge_tpu_torch.models import dinov2
    from port_bench.reference import vit

    arch = "dinov2_vitt14"
    monkeypatch.setitem(dinov2.VIT_ARCHS, arch, dataclasses.replace(dinov2.VIT_ARCHS[arch], ffn="swiglu"))
    monkeypatch.setitem(vit.ARCHS, arch, vit.ARCHS[arch][:3] + ("swiglu",))


def cell(name: str):
    """(BENCHMARK.json, the cell's file, its configuration) with the model
    and the traffic cut to a CPU test's size; limits as committed."""
    bench, workload, config = harness.load_cell(harness.ROOT, name)
    config = copy.deepcopy(config)
    if config["version"] == "v2":
        config["model_config"] = copy.deepcopy(V2)
    else:
        config["model_config"].update(encoder="dinov2_vitt14", dim_proj=32, dim_upsample=[16, 16, 16],
                                      last_conv_channels=8, num_tokens_range=[16, 36])
    workload = dict(workload)
    if workload["kind"] == "serve":
        workload.update(height=56, width=56, num_tokens=16, rate_per_s=12.0, sample=3, profile_tail_s=0.5)
    else:
        workload.update(batch=min(workload["batch"], 2), height=60, width=80, pool=4, sample=3, profile_tail_s=0.5)
    return bench, workload, config


def no_card(monkeypatch) -> None:
    """The calls the harness makes on the card, made harmless on the CPU."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)


def run(name: str, seconds: float = 1.0, seed: int = 2 ** 31 + 7, int8: bool = False):
    """One untraced run of a tiny cell on the CPU: the result line's object;
    ``int8`` runs MoGe-2's W8A8 int8 encoder in the program's place."""
    bench, workload, config = cell(name)
    return harness.execute(bench, name, workload, config, seed, seconds, False, torch.device("cpu"),
                           time.perf_counter(), int8=int8)
