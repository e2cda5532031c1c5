"""Camera/geometry ops of the inference path (port of the matching
functions of moge_tpu/ops/geometry.py). OpenCV convention: x right, y down,
z forward; normalized image coordinates in [0, 1]."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["normalized_view_plane_uv", "uv_map", "intrinsics_from_focal_center",
           "depth_map_to_point_map"]


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
