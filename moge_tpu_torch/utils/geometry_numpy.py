"""Host-side numpy geometry of the CLI: the pixel-center uv map, the field of
view from intrinsics, and the occlusion-edge mask of a depth map. Copies of
the matching functions of the JAX package's ``moge_tpu/utils/geometry_numpy.py``."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["uv_map_numpy", "focal_to_fov_numpy", "intrinsics_to_fov_numpy", "depth_map_edge_numpy"]


def uv_map_numpy(height: int, width: int, dtype=np.float32) -> np.ndarray:
    u = (np.arange(width, dtype=dtype) + 0.5) / width
    v = (np.arange(height, dtype=dtype) + 0.5) / height
    uu, vv = np.meshgrid(u, v, indexing="xy")
    return np.stack([uu, vv], axis=-1)


def focal_to_fov_numpy(focal):
    return 2 * np.arctan(0.5 / focal)


def intrinsics_to_fov_numpy(intrinsics: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return focal_to_fov_numpy(intrinsics[..., 0, 0]), focal_to_fov_numpy(intrinsics[..., 1, 1])


def depth_map_edge_numpy(
    depth: np.ndarray,
    rtol: Optional[float] = 0.04,
    ltol: Optional[float] = None,
    kernel_size: int = 3,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Occlusion-edge mask via local max/min depth ratio (utils3d `depth_map_edge`).

    ``rtol``: relative ratio threshold (dmax/dmin > 1+rtol);
    ``ltol``: log-space threshold (log dmax - log dmin > ltol).
    """
    import cv2

    if mask is None:
        mask = np.isfinite(depth)
    kernel = np.ones((kernel_size, kernel_size), np.uint8)
    d = depth.astype(np.float32)
    dmax = cv2.dilate(np.where(mask, d, -np.inf).astype(np.float32), kernel)
    dmin = -cv2.dilate(np.where(mask, -d, -np.inf).astype(np.float32), kernel)
    edge = np.zeros_like(mask)
    with np.errstate(invalid="ignore", divide="ignore"):
        if ltol is not None:
            edge |= (np.log(np.maximum(dmax, 1e-12)) - np.log(np.maximum(dmin, 1e-12))) > ltol
        elif rtol is not None:
            edge |= (dmax / np.maximum(dmin, 1e-12)) > (1 + rtol)
    return edge & mask
