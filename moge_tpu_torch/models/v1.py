"""MoGe-1 model and inference wrapper (port of moge_tpu/models/v1.py).

One DINOv2 backbone and one ``head``: the summed 1x1 projections of the
taken layers, three upsampling stages (UV concat, 2x transposed conv, 3x3
conv, residual blocks with a GroupNorm(1) in-norm), a bilinear resize to the
token-budget resolution, a UV concat and one output block per output
(points 3, mask 1). The input is resized by the token budget before the
backbone (bicubic, antialiased); the mask is the raw head output compared
with ``mask_threshold`` (no sigmoid). State-dict names are the reference's:
``backbone.*``, ``head.projects.N``, ``head.upsample_blocks.N.0.{0,1}`` and
``...N.{1+j}``, ``head.output_block.K.*``. 3x3 convs run kernel K3 on the
card, the ViT K1 and K2.
"""

from __future__ import annotations

from numbers import Number
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.geometry import depth_map_to_point_map, intrinsics_from_focal_center, normalized_view_plane_uv
from ..ops.resize import resize_2d
from ..ops.solvers import recover_focal_shift
from ..utils.tools import span
from .dinov2 import VIT_ARCHS, DinoVisionTransformer
from .modules import (IMAGENET_MEAN, IMAGENET_STD, Conv1x1, Conv3x3, ConvTranspose2x, ResidualConvBlock, conv2d,
                      init_params)
from .v2 import remap_points

__all__ = ["HeadUpsampleStage", "HeadOutputBlock", "MoGeV1Head", "MoGeV1", "MoGeModel", "normalize_config"]


def _res_blocks(count: int, channels: int, hidden_times: int, norm: str) -> List[ResidualConvBlock]:
    """MoGe-1's residual blocks: GroupNorm(1) in-norm, ``norm`` hidden norm, ReLU."""
    return [ResidualConvBlock(channels, channels, hidden_times * channels, "relu", "layer_norm", norm)
            for _ in range(count)]


class HeadUpsampleStage(nn.Sequential):
    """[[ConvTranspose 2x, conv 3x3], res blocks...] (reference indices 0.0, 0.1, 1+j)."""

    def __init__(self, in_channels: int, out_channels: int, num_res_blocks: int,
                 dim_times_res_block_hidden: int, res_block_norm: str):
        super().__init__(nn.Sequential(ConvTranspose2x(in_channels, out_channels), Conv3x3(out_channels, out_channels)),
                         *_res_blocks(num_res_blocks, out_channels, dim_times_res_block_hidden, res_block_norm))


class HeadOutputBlock(nn.Sequential):
    """[conv 3x3, res blocks..., ReLU, conv k x k] (reference indices 0, 1+j, 1+n, 2+n)."""

    def __init__(self, in_channels: int, dim_out: int, last_res_blocks: int, last_conv_channels: int,
                 last_conv_size: int, dim_times_res_block_hidden: int, res_block_norm: str):
        super().__init__(Conv3x3(in_channels, last_conv_channels),
                         *_res_blocks(last_res_blocks, last_conv_channels, dim_times_res_block_hidden, res_block_norm),
                         nn.ReLU(), conv2d(last_conv_channels, dim_out, last_conv_size))


def _with_uv(x: torch.Tensor, aspect_ratio: float) -> torch.Tensor:
    """``x`` (B, H, W, C) with the (H, W) view-plane UV map appended as 2 channels."""
    b, h, w, _ = x.shape
    uv = normalized_view_plane_uv(w, h, aspect_ratio, dtype=x.dtype, device=x.device)
    return torch.cat([x, uv[None].expand(b, h, w, 2)], dim=-1)


class MoGeV1Head(nn.Module):
    def __init__(self, num_features: int, dim_in: int, dim_out: Sequence[int], dim_proj: int = 512,
                 dim_upsample: Sequence[int] = (256, 128, 128), dim_times_res_block_hidden: int = 1,
                 num_res_blocks: int = 1, res_block_norm: str = "group_norm", last_res_blocks: int = 0,
                 last_conv_channels: int = 32, last_conv_size: int = 1):
        super().__init__()
        self.projects = nn.ModuleList(Conv1x1(dim_in, dim_proj) for _ in range(num_features))
        dims = [dim_proj, *dim_upsample]
        self.upsample_blocks = nn.ModuleList(
            HeadUpsampleStage(d_in + 2, d_out, num_res_blocks, dim_times_res_block_hidden, res_block_norm)
            for d_in, d_out in zip(dims[:-1], dims[1:]))
        self.output_block = nn.ModuleList(
            HeadOutputBlock(dims[-1] + 2, d, last_res_blocks, last_conv_channels, last_conv_size,
                            dim_times_res_block_hidden, res_block_norm)
            for d in dim_out)

    def forward(self, features: List[Tuple[torch.Tensor, torch.Tensor]], img_h: int, img_w: int,
                patch_h: int, patch_w: int) -> List[torch.Tensor]:
        """Outputs at (img_h, img_w), in the features' dtype."""
        batch = features[0][0].shape[0]
        x = None
        for proj, (feat, _cls) in zip(self.projects, features):
            y = proj(feat.reshape(batch, patch_h, patch_w, -1))
            x = y if x is None else x + y
        aspect_ratio = img_w / img_h
        for stage in self.upsample_blocks:
            x = stage(_with_uv(x, aspect_ratio))
        x = _with_uv(resize_2d(x, (img_h, img_w), mode="bilinear"), aspect_ratio)
        return [block(x) for block in self.output_block]


class MoGeV1(nn.Module):
    """Config-described MoGe-1 (the checkpoint's ``model_config`` schema).
    ``remat`` (training) checkpoints the backbone's blocks only, as the JAX
    package's; ``normalize_config`` drops the key."""

    def __init__(self, encoder: str = "dinov2_vitb14", intermediate_layers: Union[int, Sequence[int]] = 4,
                 dim_proj: int = 512, dim_upsample: Sequence[int] = (256, 128, 128),
                 dim_times_res_block_hidden: int = 1, num_res_blocks: int = 1, remap_output: str = "linear",
                 res_block_norm: str = "group_norm", num_tokens_range: Sequence[int] = (1200, 2500),
                 last_res_blocks: int = 0, last_conv_channels: int = 32, last_conv_size: int = 1,
                 mask_threshold: float = 0.5, remat: bool = False):
        super().__init__()
        vit = VIT_ARCHS[encoder]
        self.remap_output = remap_output
        self.num_tokens_range = list(num_tokens_range)
        self.mask_threshold = mask_threshold
        if isinstance(intermediate_layers, int):
            self.take_layers = tuple(range(vit.depth - intermediate_layers, vit.depth))
        else:
            self.take_layers = tuple(intermediate_layers)
        self.backbone = DinoVisionTransformer(vit, remat=remat)
        self.head = MoGeV1Head(len(self.take_layers), vit.embed_dim, [3, 1], dim_proj, dim_upsample,
                               dim_times_res_block_hidden, num_res_blocks, res_block_norm, last_res_blocks,
                               last_conv_channels, last_conv_size)
        self.register_buffer("image_mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1))
        self.register_buffer("image_std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1))

    def forward(self, image: torch.Tensor, num_tokens: int, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
        """``image`` (B, H, W, 3) RGB in [0, 1]. Returns 'points' (B, H, W, 3)
        and the raw 'mask' (B, H, W), fp32; the network runs in ``dtype``."""
        _, img_h, img_w, _ = image.shape
        points, mask = self.decode(image, num_tokens, dtype)
        return self.epilogue(points, mask, img_h, img_w)

    def decode(self, image: torch.Tensor, num_tokens: int, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """The resize to the token grid, the backbone and the head (spans
        ``moge.resize``, ``moge.encoder``, ``moge.decoder``; the last two
        open no range): the raw points (B, h, w, 3) and mask (B, h, w, 1) at
        the resized size, in ``dtype``."""
        _, img_h, img_w, _ = image.shape
        with span("moge.resize", device=True):
            factor = ((num_tokens * 14 ** 2) / (img_h * img_w)) ** 0.5
            resized_w, resized_h = int(img_w * factor), int(img_h * factor)
            image = resize_2d(image.float(), (resized_h, resized_w), mode="bicubic", antialias=True)
            image = (image - self.image_mean.view(3)) / self.image_std.view(3)
            patch_h, patch_w = resized_h // 14, resized_w // 14
            image_14 = resize_2d(image, (patch_h * 14, patch_w * 14), mode="bilinear", antialias=True)
        with span("moge.encoder", device=True, host_range=False):
            features = self.backbone(image_14, self.take_layers, dtype)
        with span("moge.decoder", device=True, host_range=False):
            points, mask = self.head(features, resized_h, resized_w, patch_h, patch_w)
        return points, mask

    def epilogue(self, points: torch.Tensor, mask: torch.Tensor, img_h: int, img_w: int) -> Dict[str, torch.Tensor]:
        """``decode``'s raw maps resized to (img_h, img_w) and remapped, in fp32."""
        points = resize_2d(points.float(), (img_h, img_w), mode="bilinear")
        mask = resize_2d(mask.float(), (img_h, img_w), mode="bilinear")
        return {"points": remap_points(points, self.remap_output), "mask": mask[..., 0]}

    def init_random(self, seed: int = 0) -> "MoGeV1":
        """Random init with the JAX package's distributions (``init_params``)."""
        init_params(self, seed)
        return self


_CONFIG_KEYS = ("encoder", "intermediate_layers", "dim_proj", "dim_upsample", "dim_times_res_block_hidden",
                "num_res_blocks", "remap_output", "res_block_norm", "num_tokens_range", "last_res_blocks",
                "last_conv_channels", "last_conv_size", "mask_threshold")


def normalize_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """A checkpoint's ``model_config`` -> ``MoGeV1`` kwargs: the legacy
    ``trained_area_range`` (pixels) becomes ``num_tokens_range``, a boolean
    ``remap_output`` becomes 'exp' / 'linear', unknown keys are dropped."""
    config = dict(config)
    if "trained_area_range" in config:
        lo, hi = config.pop("trained_area_range")
        config["num_tokens_range"] = [lo // 14 ** 2, hi // 14 ** 2]
    if config.get("remap_output") is True:
        config["remap_output"] = "exp"
    elif config.get("remap_output") is False:
        config["remap_output"] = "linear"
    return {k: v for k, v in config.items() if k in _CONFIG_KEYS}


class MoGeModel:
    """User-facing MoGe-1: holds a ``MoGeV1`` on a device and runs ``infer``."""

    version = "v1"

    def __init__(self, config: Dict[str, Any], device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.bfloat16):
        self.config = normalize_config(config)
        self.device = torch.device(device)
        self.dtype = dtype
        with self.device:  # parameters are allocated on the device (uninitialised until loaded)
            self.module = MoGeV1(**self.config).eval()

    @classmethod
    def from_pretrained(cls, path, device: Union[str, torch.device] = "cuda", dtype: torch.dtype = torch.bfloat16,
                        model_kwargs: Optional[Dict[str, Any]] = None) -> "MoGeModel":
        """Load a reference-format MoGe-1 checkpoint ``{'model_config', 'model'}``."""
        from .io import load_checkpoint

        config, state_dict = load_checkpoint(path, version="v1")
        if model_kwargs:
            config.update(model_kwargs)
        model = cls(config, device, dtype)
        model.module.load_state_dict(state_dict, strict=True)
        return model

    def init_random(self, seed: int = 0) -> "MoGeModel":
        self.module.init_random(seed)
        return self

    @torch.inference_mode()
    def infer(self, image, fov_x: Optional[Union[Number, torch.Tensor]] = None, resolution_level: int = 9,
              num_tokens: Optional[int] = None, apply_mask: bool = True, force_projection: bool = True,
              use_fp16: bool = True) -> Dict[str, torch.Tensor]:
        """``image``: (H, W, 3) or (B, H, W, 3) RGB in [0, 1] (NCHW accepted).
        Returns 'points', 'depth', 'intrinsics' and the bool 'mask' (raw head
        output > ``mask_threshold``). ``use_fp16`` selects bf16 compute. Its
        stages are spans (``utils.tools.span``) inside ``moge.infer``:
        ``moge.upload``, ``moge.resize``, ``moge.encoder``, ``moge.decoder``
        (the head), ``moge.post`` (epilogue and camera) and, inside it,
        ``moge.solve``."""
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
            raw_points, raw_mask = self.module.decode(image, num_tokens, self.dtype if use_fp16 else torch.float32)
            with span("moge.post", device=True):
                out = self.module.epilogue(raw_points, raw_mask, h, w)
                points = out["points"]
                mask = out["mask"] > self.module.mask_threshold

                with span("moge.solve", device=True):
                    if fov_x is None:
                        focal, shift = recover_focal_shift(points, mask)
                    else:
                        fov = torch.deg2rad(torch.as_tensor(fov_x, dtype=torch.float32, device=points.device))
                        focal = (aspect_ratio / (1 + aspect_ratio ** 2) ** 0.5 / torch.tan(fov / 2)).expand(
                            points.shape[:-3])
                        _, shift = recover_focal_shift(points, mask, focal=focal)
                fx = focal / 2 * (1 + aspect_ratio ** 2) ** 0.5 / aspect_ratio
                fy = focal / 2 * (1 + aspect_ratio ** 2) ** 0.5
                intrinsics = intrinsics_from_focal_center(fx, fy, 0.5, 0.5)
                depth = points[..., 2] + shift[..., None, None]
                if force_projection:
                    points = depth_map_to_point_map(depth, intrinsics)
                else:  # the shift moves z only
                    points = torch.cat([points[..., :2], depth[..., None]], dim=-1)
                if apply_mask:
                    points = torch.where(mask[..., None], points, torch.inf)
                    depth = torch.where(mask, depth, torch.inf)
            result = {"points": points, "intrinsics": intrinsics, "depth": depth, "mask": mask}
            if omit_batch_dim:
                result = {k: v[0] for k, v in result.items()}
            return result
