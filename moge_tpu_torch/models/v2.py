"""MoGe-2 model and inference wrapper (port of moge_tpu/models/v2.py).

``MoGeV2`` is the nn.Module (encoder, neck, heads, scale MLP) with the
microsoft/MoGe state-dict names; its ``forward(image, num_tokens)`` is the
differentiable training forward. With ``batched_heads`` (default: the
``MOGE_BATCHED_HEADS`` environment variable, off) and a batchable head
family, ``decode`` runs the output heads as one grouped pass
(``multihead.py``) instead of one after another. ``MoGeModel`` wraps it with ``infer``,
``init_random`` and ``from_pretrained``. ``infer`` takes the JAX package's
keyword arguments and returns its keys: points, depth, intrinsics, mask,
normal. Compute is bf16 by default (``use_fp16=True``) or fp32; the
epilogue and the camera recovery run in fp32.

Two serving-mode options of the encoder, as in the JAX package:
``sp_group`` (a process group; every rank calls ``infer`` with the same
inputs, the ViT runs sequence-parallel, the rest replicated, every rank
returns the whole result; ``parallel/sp.py``) and ``use_int8`` (W8A8 int8
block projections; ``ops/quant.py``). Both are inference only.

``MoGeV2(..., remat=True)`` (training, the JAX package's ``remat``) runs the
ViT blocks and every residual block and resampler of the neck and the
heads as activation checkpoints when grad mode is on, and turns batched
heads off; the scale MLP is not rematerialized. ``MoGeModel`` drops the key
from a config, as the JAX package's does.
"""

from __future__ import annotations

import math
from numbers import Number
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..ops.geometry import depth_map_to_point_map, intrinsics_from_focal_center
from ..ops.resize import resize_2d
from ..ops.solvers import recover_focal_shift
from ..utils.tools import span
from .modules import MLP, ConvStack, DINOv2Encoder, init_params, make_level_uv
from .multihead import apply_heads_batched, batched_heads_default, heads_batchable

__all__ = ["MoGeV2", "MoGeModel", "apply_epilogue", "postprocess", "remap_points", "base_token_grid"]

_HEADS = ("points_head", "normal_head", "mask_head")


def remap_points(points: torch.Tensor, remap_output: str) -> torch.Tensor:
    if remap_output == "linear":
        return points
    if remap_output == "sinh":
        return torch.sinh(points)
    if remap_output == "exp":
        xy, z = points[..., :2], points[..., 2:]
        z = torch.exp(z)
        return torch.cat([xy * z, z], dim=-1)
    if remap_output == "sinh_exp":
        xy, z = points[..., :2], points[..., 2:]
        return torch.cat([torch.sinh(xy), torch.exp(z)], dim=-1)
    raise ValueError(f"Invalid remap output type: {remap_output}")


def base_token_grid(num_tokens: int, aspect_ratio: float) -> Tuple[int, int]:
    """(base_h, base_w) from the token budget."""
    return round((num_tokens / aspect_ratio) ** 0.5), round((num_tokens * aspect_ratio) ** 0.5)


class MoGeV2(nn.Module):
    """Config-described MoGe-2 (the checkpoint's ``model_config`` schema)."""

    def __init__(self, encoder: Dict[str, Any], neck: Dict[str, Any],
                 points_head: Optional[Dict[str, Any]] = None, mask_head: Optional[Dict[str, Any]] = None,
                 normal_head: Optional[Dict[str, Any]] = None, scale_head: Optional[Dict[str, Any]] = None,
                 remap_output: str = "linear", num_tokens_range=(1200, 3600),
                 batched_heads: Optional[bool] = None, sp_group=None, use_int8: bool = False,
                 remat: bool = False):
        super().__init__()
        self.remap_output = remap_output
        self.num_tokens_range = list(num_tokens_range)
        self.encoder = DINOv2Encoder(**encoder, sp_group=sp_group, use_int8=use_int8, remat=remat)
        self.neck = ConvStack(**neck, remat=remat)
        head_cfgs = []
        for name, cfg in (("points_head", points_head), ("normal_head", normal_head), ("mask_head", mask_head)):
            if cfg is not None:
                setattr(self, name, ConvStack(**cfg, remat=remat))
                head_cfgs.append(cfg)
        if batched_heads is None:
            batched_heads = batched_heads_default()
        self.batched_heads = batched_heads and heads_batchable(head_cfgs, remat)
        if scale_head is not None:
            self.scale_head = MLP(**scale_head)

    def decode(self, image_14: torch.Tensor, base_h: int, base_w: int, aspect_ratio: float,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """Encoder + neck + heads at decoder resolution. ``image_14``: (B,
        14*base_h, 14*base_w, 3) RGB in [0, 1]. Returns raw maps
        'points_raw'/'normal_raw' (B, 16bh, 16bw, 3), 'mask_raw' logits
        (B, 16bh, 16bw, 1) and 'metric_scale' (B,), in ``dtype``. Spans
        ``moge.encoder`` and ``moge.decoder``, with no range (``span``)."""
        batch = image_14.shape[0]
        with span("moge.encoder", device=True, host_range=False):
            features, cls_token = self.encoder(image_14, base_h, base_w, dtype)
        with span("moge.decoder", device=True, host_range=False):
            uvs = make_level_uv(base_h, base_w, 5, aspect_ratio, batch, dtype, image_14.device)
            in_features = [torch.cat([features, uvs[0]], dim=-1), *uvs[1:]]
            neck_features = self.neck(in_features)
            names = [name for name in _HEADS if hasattr(self, name)]
            if self.batched_heads:  # one grouped pass over all heads
                raws = apply_heads_batched([getattr(self, name) for name in names], neck_features, dtype)
            else:  # heads one after another
                raws = [getattr(self, name)(neck_features)[-1] for name in names]
            out: Dict[str, torch.Tensor] = {name.replace("_head", "_raw"): raw for name, raw in zip(names, raws)}
            if hasattr(self, "scale_head"):
                out["metric_scale"] = torch.exp(self.scale_head(cls_token)[..., 0])
        return out

    def forward(self, image: torch.Tensor, num_tokens: int,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
        """Training forward (the JAX ``MoGeV2.__call__``): ``image`` (B, H, W, 3)
        RGB in [0, 1]. Antialiased fp32 resize to the token grid, decode in
        ``dtype``, fp32 epilogue. Returns 'points', 'normal' (B, H, W, 3),
        'mask_logit', 'mask' (B, H, W) and 'metric_scale' (B,), whichever
        heads exist. Differentiable w.r.t. every parameter."""
        _, img_h, img_w, _ = image.shape
        aspect_ratio = img_w / img_h
        base_h, base_w = base_token_grid(num_tokens, aspect_ratio)
        image_14 = resize_2d(image.float(), (base_h * 14, base_w * 14), mode="bilinear", antialias=True)
        raw = self.decode(image_14, base_h, base_w, aspect_ratio, dtype)
        return apply_epilogue(raw, img_h, img_w, self.remap_output)

    def init_random(self, seed: int = 0) -> "MoGeV2":
        """Random init with the JAX package's distributions (``init_params``)."""
        init_params(self, seed)
        return self


def apply_epilogue(raw: Dict[str, torch.Tensor], img_h: int, img_w: int,
                   remap_output: str) -> Dict[str, torch.Tensor]:
    """Bilinear resize of the raw maps to (H, W) + remap / normalize / sigmoid.
    Runs in fp32 whatever the decode dtype."""
    out: Dict[str, torch.Tensor] = {}
    if "points_raw" in raw:
        pred = resize_2d(raw["points_raw"].float(), (img_h, img_w), mode="bilinear")
        out["points"] = remap_points(pred, remap_output)
    if "normal_raw" in raw:
        pred = resize_2d(raw["normal_raw"].float(), (img_h, img_w), mode="bilinear")
        norm = torch.sqrt(pred.square().sum(-1, keepdim=True) + 1e-24)
        out["normal"] = pred / norm.clamp_min(1e-12)
    if "mask_raw" in raw:
        pred = resize_2d(raw["mask_raw"].float(), (img_h, img_w), mode="bilinear")
        out["mask_logit"] = pred[..., 0]
        out["mask"] = torch.sigmoid(pred[..., 0])
    if "metric_scale" in raw:
        out["metric_scale"] = raw["metric_scale"]
    return out


def postprocess(output: Dict[str, torch.Tensor], aspect_ratio: float,
                fov_x: Optional[Union[Number, torch.Tensor]] = None, force_projection: bool = True,
                apply_mask: bool = True, use_mask_for_solve: bool = True,
                mask_threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """fp32 camera recovery, depth, intrinsics and masking."""
    points, normal = output.get("points"), output.get("normal")
    mask, metric_scale = output.get("mask"), output.get("metric_scale")
    points = points.float() if points is not None else None
    normal = normal.float() if normal is not None else None
    metric_scale = metric_scale.float() if metric_scale is not None else None

    result: Dict[str, torch.Tensor] = {}
    mask_binary = (mask.float() > mask_threshold) if mask is not None else None
    if points is not None:
        solve_mask = mask_binary if use_mask_for_solve else None
        with span("moge.solve", device=True):
            if fov_x is None:
                focal, shift = recover_focal_shift(points, solve_mask)
            else:
                fov = torch.deg2rad(torch.as_tensor(fov_x, dtype=torch.float32, device=points.device))
                focal = aspect_ratio / (1 + aspect_ratio ** 2) ** 0.5 / torch.tan(fov / 2)
                focal = focal.expand(points.shape[:-3])
                _, shift = recover_focal_shift(points, solve_mask, focal=focal)
        fx = focal / 2 * (1 + aspect_ratio ** 2) ** 0.5 / aspect_ratio
        fy = focal / 2 * (1 + aspect_ratio ** 2) ** 0.5
        intrinsics = intrinsics_from_focal_center(fx, fy, 0.5, 0.5)
        points = torch.cat([points[..., :2], points[..., 2:] + shift[..., None, None, None]], dim=-1)
        if mask_binary is not None:
            mask_binary = mask_binary & (points[..., 2] > 0)
        depth = points[..., 2]
        if force_projection:
            points = depth_map_to_point_map(depth, intrinsics)
        if metric_scale is not None:
            points = points * metric_scale[..., None, None, None]
            depth = depth * metric_scale[..., None, None]
        if apply_mask and mask_binary is not None:
            points = torch.where(mask_binary[..., None], points, math.inf)
            depth = torch.where(mask_binary, depth, math.inf)
            if normal is not None:
                normal = torch.where(mask_binary[..., None], normal, 0.0)
        result["points"] = points
        result["depth"] = depth
        result["intrinsics"] = intrinsics
    if mask_binary is not None:
        result["mask"] = mask_binary
    if normal is not None:
        result["normal"] = normal
    return result


class MoGeModel:
    """User-facing MoGe-2: holds a ``MoGeV2`` on a device and runs ``infer``."""

    version = "v2"
    _CONFIG_KEYS = ("encoder", "neck", "points_head", "mask_head", "normal_head",
                    "scale_head", "remap_output", "num_tokens_range")

    def __init__(self, config: Dict[str, Any], device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.bfloat16, batched_heads: Optional[bool] = None,
                 sp_group=None, use_int8: bool = False):
        self.config = {k: v for k, v in config.items() if k in self._CONFIG_KEYS}
        self.device = torch.device(device)
        self.dtype = dtype
        self.sp_group = sp_group
        with self.device:  # parameters are allocated on the device (uninitialised until loaded)
            self.module = MoGeV2(**self.config, batched_heads=batched_heads, sp_group=sp_group,
                                 use_int8=use_int8).eval()

    @classmethod
    def from_pretrained(cls, path, device: Union[str, torch.device] = "cuda", dtype: torch.dtype = torch.bfloat16,
                        model_kwargs: Optional[Dict[str, Any]] = None, use_int8: bool = False) -> "MoGeModel":
        """Load a reference-format checkpoint ``{'model_config', 'model'}``."""
        from .io import load_checkpoint

        config, state_dict = load_checkpoint(path, version="v2")
        if model_kwargs:
            config.update(model_kwargs)
        model = cls(config, device, dtype, use_int8=use_int8)
        model.module.load_state_dict(state_dict, strict=True)
        return model

    def init_random(self, seed: int = 0) -> "MoGeModel":
        self.module.init_random(seed)
        return self

    @torch.inference_mode()
    def infer(self, image, num_tokens: Optional[int] = None, resolution_level: int = 9,
              force_projection: bool = True, apply_mask: bool = True,
              fov_x: Optional[Union[Number, torch.Tensor]] = None,
              use_fp16: bool = True) -> Dict[str, torch.Tensor]:
        """``image``: (H, W, 3) or (B, H, W, 3) RGB in [0, 1] (NCHW accepted).
        ``use_fp16`` selects bf16 compute; False runs fp32. Its stages are
        spans (``utils.tools.span``) inside ``moge.infer``: ``moge.upload``,
        ``moge.resize``, ``moge.encoder``, ``moge.decoder`` (neck, heads,
        scale MLP), ``moge.post`` (epilogue and ``postprocess``) and, inside
        it, ``moge.solve``."""
        with span("moge.infer", device=True):
            with span("moge.upload"):
                if not isinstance(image, torch.Tensor):
                    image = torch.as_tensor(np.asarray(image))
                image = image.to(self.device, torch.float32)
            omit_batch_dim = image.dim() == 3
            if omit_batch_dim:
                image = image[None]
            if image.shape[-1] != 3:
                image = image.movedim(-3, -1)
            h, w = image.shape[-3], image.shape[-2]
            aspect_ratio = w / h
            if num_tokens is None:
                lo, hi = self.module.num_tokens_range
                num_tokens = int(lo + (resolution_level / 9) * (hi - lo))
            base_h, base_w = base_token_grid(num_tokens, aspect_ratio)
            dtype = self.dtype if use_fp16 else torch.float32

            with span("moge.resize", device=True):
                image_14 = resize_2d(image, (base_h * 14, base_w * 14), mode="bilinear", antialias=True)
            raw = self.module.decode(image_14, base_h, base_w, aspect_ratio, dtype)
            with span("moge.post", device=True):
                full = apply_epilogue(raw, h, w, self.module.remap_output)
                out = postprocess(full, aspect_ratio, fov_x, force_projection, apply_mask)
            if omit_batch_dim:
                out = {k: v[0] for k, v in out.items()}
            return out
