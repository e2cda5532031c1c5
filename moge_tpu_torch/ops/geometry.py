"""Camera/geometry ops of the inference and training paths (port of the
matching functions of moge_tpu/ops/geometry.py). OpenCV convention: x right,
y down, z forward; normalized image coordinates in [0, 1]."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["normalized_view_plane_uv", "uv_map", "intrinsics_from_focal_center",
           "depth_map_to_point_map", "weighted_mean", "harmonic_mean", "safe_norm", "angle_diff_vec3",
           "masked_nearest_resize"]

Dims = Optional[Union[int, Sequence[int]]]


def normalized_view_plane_uv(width: int, height: int, aspect_ratio: Optional[float] = None,
                             dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """UV grid spanning +-(w/diag, h/diag) at pixel centers, shape (H, W, 2)
    (computed in float64 on the host, like the JAX package)."""
    if aspect_ratio is None:
        aspect_ratio = width / height
    span_x = aspect_ratio / (1 + aspect_ratio ** 2) ** 0.5
    span_y = 1 / (1 + aspect_ratio ** 2) ** 0.5
    u = np.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width, width, dtype=np.float64)
    v = np.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height, height, dtype=np.float64)
    uu, vv = np.meshgrid(u, v, indexing="xy")
    return torch.as_tensor(np.stack([uu, vv], axis=-1), dtype=dtype, device=device)


def uv_map(height: int, width: int, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Pixel-center UV in [0, 1]^2, shape (H, W, 2)."""
    u = (np.arange(width, dtype=np.float64) + 0.5) / width
    v = (np.arange(height, dtype=np.float64) + 0.5) / height
    uu, vv = np.meshgrid(u, v, indexing="xy")
    return torch.as_tensor(np.stack([uu, vv], axis=-1), dtype=dtype, device=device)


def intrinsics_from_focal_center(fx, fy, cx, cy) -> torch.Tensor:
    """Normalized pinhole intrinsics (..., 3, 3) from broadcastable fx, fy, cx, cy."""
    ref = next(t for t in (fx, fy, cx, cy) if isinstance(t, torch.Tensor))
    fx, fy, cx, cy = torch.broadcast_tensors(
        *(torch.as_tensor(t, dtype=ref.dtype, device=ref.device) for t in (fx, fy, cx, cy)))
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    rows = [torch.stack([fx, zeros, cx], dim=-1),
            torch.stack([zeros, fy, cy], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1)]
    return torch.stack(rows, dim=-2)


def depth_map_to_point_map(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject (..., H, W) depth with normalized intrinsics (..., 3, 3) ->
    (..., H, W, 3): x = (u - cx) / fx * z, y = (v - cy) / fy * z."""
    height, width = depth.shape[-2:]
    uv = uv_map(height, width, dtype=depth.dtype, device=depth.device)
    fx = intrinsics[..., 0, 0][..., None, None]
    fy = intrinsics[..., 1, 1][..., None, None]
    cx = intrinsics[..., 0, 2][..., None, None]
    cy = intrinsics[..., 1, 2][..., None, None]
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def _mean(x: torch.Tensor, dim: Dims, keepdim: bool) -> torch.Tensor:
    return x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)


def weighted_mean(x: torch.Tensor, w: Optional[torch.Tensor] = None, dim: Dims = None, keepdim: bool = False,
                  eps: float = 1e-7) -> torch.Tensor:
    """mean(x * w) / (mean(w) + eps) over ``dim`` (all axes when None)."""
    if w is None:
        return _mean(x, dim, keepdim)
    w = w.to(x.dtype)
    return _mean(x * w, dim, keepdim) / (_mean(w, dim, keepdim) + eps)


def harmonic_mean(x: torch.Tensor, w: Optional[torch.Tensor] = None, dim: Dims = None, keepdim: bool = False,
                  eps: float = 1e-7) -> torch.Tensor:
    if w is None:
        return 1.0 / _mean(1.0 / (x + eps), dim, keepdim)
    return 1.0 / (weighted_mean(1.0 / (x + eps), w, dim, keepdim, eps) + eps)


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False, eps: float = 1e-20) -> torch.Tensor:
    """L2 norm with a finite gradient at 0."""
    return torch.sqrt(x.square().sum(dim=dim, keepdim=keepdim) + eps)


def angle_diff_vec3(v1: torch.Tensor, v2: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Angle between 3-vectors (last axis) via atan2."""
    return torch.atan2(safe_norm(torch.linalg.cross(v1, v2, dim=-1)) + eps, (v1 * v2).sum(-1))


def masked_nearest_resize(*images: torch.Tensor, mask: torch.Tensor, size: Tuple[int, int],
                          return_index: bool = False):
    """Nearest resize that snaps each output pixel to the nearest *valid*
    input pixel: each target cell searches a window around its nearest source
    pixel and takes the closest valid one (first in window order on ties);
    the output mask marks cells whose window held a valid pixel.

    ``images``: (..., H, W, C) or (..., H, W) tensors sharing ``mask``
    (..., H, W) bool. Returns the resized images and mask (and, with
    ``return_index``, the source (row, col) index maps). Gradients flow to
    the images through the gathers."""
    height, width = mask.shape[-2:]
    out_h, out_w = size
    filter_h = math.ceil(height / out_h) if out_h < height else 1
    filter_w = math.ceil(width / out_w) if out_w < width else 1
    kh, kw = filter_h + (1 - filter_h % 2), filter_w + (1 - filter_w % 2)

    # nearest source centre per target pixel and the window around it (host, static)
    ti = (np.arange(out_h) + 0.5) * (height / out_h) - 0.5
    tj = (np.arange(out_w) + 0.5) * (width / out_w) - 0.5
    cand_i = np.clip(np.round(ti).astype(np.int64), 0, height - 1)[:, None] + np.arange(-(kh // 2), kh // 2 + 1)
    cand_j = np.clip(np.round(tj).astype(np.int64), 0, width - 1)[:, None] + np.arange(-(kw // 2), kw // 2 + 1)
    valid_i = (cand_i >= 0) & (cand_i < height)
    valid_j = (cand_j >= 0) & (cand_j < width)
    cand_i, cand_j = np.clip(cand_i, 0, height - 1), np.clip(cand_j, 0, width - 1)

    dev = mask.device
    as_t = lambda a, dtype: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    ci, cj = as_t(cand_i, torch.int64), as_t(cand_j, torch.int64)
    m = mask.index_select(-2, ci.reshape(-1)).reshape(*mask.shape[:-2], out_h, kh, width)
    m = m.index_select(-1, cj.reshape(-1)).reshape(*mask.shape[:-2], out_h, kh, out_w, kw)
    m = m & (as_t(valid_i, torch.bool)[:, :, None, None] & as_t(valid_j, torch.bool)[None, None])
    dist = (as_t((cand_i - ti[:, None]) ** 2, torch.float32)[:, :, None, None]
            + as_t((cand_j - tj[:, None]) ** 2, torch.float32)[None, None])
    dist = torch.where(m, dist, math.inf).movedim(-3, -2).flatten(-2)  # (..., out_h, out_w, kh*kw)
    best = dist.argmin(-1)
    out_mask = torch.isfinite(dist.amin(-1))
    src_i = ci[torch.arange(out_h, device=dev)[:, None], best // kw]
    src_j = cj[torch.arange(out_w, device=dev)[None, :], best % kw]
    flat_idx = (src_i * width + src_j).flatten(-2)  # (..., out_h * out_w)

    lead = mask.shape[:-2]
    outputs = []
    for img in images:
        if img.dim() == mask.dim() + 1:
            c = img.shape[-1]
            g = img.reshape(*lead, height * width, c).gather(-2, flat_idx[..., None].expand(*flat_idx.shape, c))
            outputs.append(g.reshape(*lead, out_h, out_w, c))
        else:
            outputs.append(img.reshape(*lead, height * width).gather(-1, flat_idx).reshape(*lead, out_h, out_w))
    if return_index:
        return (*outputs, out_mask, (src_i, src_j))
    return (*outputs, out_mask)
