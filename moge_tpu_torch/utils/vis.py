"""Depth, disparity, normal, segmentation and error-map colorization
(reference moge/utils/vis.py; Spectral, Set1 and plasma colormaps). Copies
of the JAX package's ``moge_tpu/utils/vis.py``; matplotlib is imported
inside the functions."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["colorize_depth", "colorize_depth_affine", "colorize_disparity", "colorize_segmentation",
           "colorize_normal", "colorize_error_map"]


def _nanquantile_range(x: np.ndarray, lo: float, hi: float) -> Tuple[float, float]:
    """Quantile range that is quiet on all-NaN input (fully masked maps) and
    never returns a zero span (constant maps render mid-colormap, not NaN)."""
    if not np.isfinite(x).any():
        return 0.0, 1.0
    vmin, vmax = np.nanquantile(x, lo), np.nanquantile(x, hi)
    if vmax - vmin < 1e-12:
        vmin, vmax = vmin - 0.5, vmax + 0.5
    return vmin, vmax


def colorize_depth(depth: np.ndarray, mask: Optional[np.ndarray] = None, normalize: bool = True,
                   cmap: str = "Spectral") -> np.ndarray:
    import matplotlib

    if mask is None:
        depth = np.where(depth > 0, depth, np.nan)
    else:
        depth = np.where((depth > 0) & mask, depth, np.nan)
    disp = 1 / depth
    if normalize:
        min_disp, max_disp = _nanquantile_range(disp, 0.001, 0.99)
        disp = (disp - min_disp) / (max_disp - min_disp)
    colored = np.nan_to_num(matplotlib.colormaps[cmap](1.0 - disp)[..., :3], 0)
    return np.ascontiguousarray((colored.clip(0, 1) * 255).astype(np.uint8))


def colorize_depth_affine(depth: np.ndarray, mask: Optional[np.ndarray] = None, cmap: str = "Spectral") -> np.ndarray:
    import matplotlib

    if mask is not None:
        depth = np.where(mask, depth, np.nan)
    min_depth, max_depth = _nanquantile_range(depth, 0.001, 0.999)
    depth = (depth - min_depth) / (max_depth - min_depth)
    colored = np.nan_to_num(matplotlib.colormaps[cmap](depth)[..., :3], 0)
    return np.ascontiguousarray((colored.clip(0, 1) * 255).astype(np.uint8))


def colorize_disparity(disparity: np.ndarray, mask: Optional[np.ndarray] = None, normalize: bool = True,
                       cmap: str = "Spectral") -> np.ndarray:
    import matplotlib

    if mask is not None:
        disparity = np.where(mask, disparity, np.nan)
    if normalize:
        min_disp, max_disp = _nanquantile_range(disparity, 0.001, 0.999)
        disparity = (disparity - min_disp) / (max_disp - min_disp)
    colored = np.nan_to_num(matplotlib.colormaps[cmap](1.0 - disparity)[..., :3], 0)
    return np.ascontiguousarray((colored.clip(0, 1) * 255).astype(np.uint8))


def colorize_segmentation(segmentation: np.ndarray, cmap: str = "Set1") -> np.ndarray:
    import matplotlib

    colored = matplotlib.colormaps[cmap]((segmentation % 20) / 20)[..., :3]
    return np.ascontiguousarray((colored.clip(0, 1) * 255).astype(np.uint8))


def colorize_normal(normal: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
    if mask is not None:
        normal = np.where(mask[..., None], normal, 0)
    normal = normal * [0.5, -0.5, -0.5] + 0.5
    return (normal.clip(0, 1) * 255).astype(np.uint8)


def colorize_error_map(error_map: np.ndarray, mask: Optional[np.ndarray] = None, cmap: str = "plasma",
                       value_range: Optional[Tuple[float, float]] = None) -> np.ndarray:
    import matplotlib

    vmin, vmax = value_range if value_range is not None else _nanquantile_range(error_map, 0.0, 1.0)
    colored = matplotlib.colormaps[cmap](((error_map - vmin) / (vmax - vmin)).clip(0, 1))[..., :3]
    if mask is not None:
        colored = np.where(mask[..., None], colored, 0)
    return np.ascontiguousarray((colored.clip(0, 1) * 255).astype(np.uint8))
