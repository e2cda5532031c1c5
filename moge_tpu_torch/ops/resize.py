"""Image resampling (port of moge_tpu/ops/resize.py).

The JAX package builds its resampling matrices to reproduce
``torch.nn.functional.interpolate`` exactly, so the port calls
``F.interpolate`` itself, in the flavours inference uses: antialiased
bilinear (input resize), plain bilinear (output epilogue), legacy nearest
(the solver's downsample and the ``nearest`` resampler), bicubic with a
``scale_factor`` (the DINOv2 pos-embed interpolation) and antialiased
bicubic to a size (MoGe-1's input resize). ``resize_image`` is the public
NHWC entry; ``resize_matrix`` is the JAX package's dense (out, in)
resampling matrix, a numpy copy of its construction (ATen's sampling rules
in float64), for callers that resample by matrix products.
"""

from __future__ import annotations

import functools
from typing import Literal, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize_2d", "resize_image", "resize_matrix"]

Mode = Literal["nearest", "bilinear", "bicubic"]

_CUBIC_A = -0.75


def _cubic_weight(x: np.ndarray, a: float = _CUBIC_A) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


def _linear_weight(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _compute_scale(in_size: int, out_size: int, scale_factor: Optional[float]) -> float:
    """ATen's ``area_pixel_compute_scale`` (align_corners=False): a given scale factor wins."""
    if scale_factor is not None and scale_factor > 0:
        return 1.0 / scale_factor
    return in_size / out_size


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int, mode: Mode = "bilinear", antialias: bool = False,
                  scale_factor: Optional[float] = None) -> np.ndarray:
    """(out_size, in_size) float32 matrix of a 1-D resampling as
    ``F.interpolate`` computes it (align_corners=False; legacy nearest; the
    antialiased kernels PIL's, bicubic's with A = -0.5)."""
    scale = _compute_scale(in_size, out_size, scale_factor)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    if mode == "nearest":
        idx = np.minimum(np.floor(np.arange(out_size) * scale).astype(np.int64), in_size - 1)
        mat[np.arange(out_size), idx] = 1.0
        return mat.astype(np.float32)
    dst = np.arange(out_size, dtype=np.float64)
    if antialias:
        interp_size = 2 if mode == "bilinear" else 4
        filt = _linear_weight if mode == "bilinear" else functools.partial(_cubic_weight, a=-0.5)
        support = (interp_size / 2) * scale if scale >= 1.0 else (interp_size / 2)
        invscale = 1.0 / scale if scale >= 1.0 else 1.0
        center = scale * (dst + 0.5)
        xmin = np.maximum(center - support + 0.5, 0.0).astype(np.int64)
        xmax = np.minimum(center + support + 0.5, float(in_size)).astype(np.int64)
        for i in range(out_size):
            j = np.arange(xmin[i], xmax[i])
            w = filt((j + 0.5 - center[i]) * invscale)
            total = w.sum()
            if total != 0.0:
                w = w / total
            mat[i, j] = w
        return mat.astype(np.float32)
    # ATen computes the source index in the input's type (fp32 here)
    src = (np.float32(scale) * (dst.astype(np.float32) + np.float32(0.5)) - np.float32(0.5)).astype(np.float64)
    if mode == "bilinear":
        src = np.maximum(src, 0.0)  # the linear path clamps the source index
        x0 = np.floor(src).astype(np.int64)
        lam = np.clip(src - x0, 0.0, 1.0)
        x0 = np.clip(x0, 0, in_size - 1)
        x1 = np.minimum(x0 + 1, in_size - 1)
        for i in range(out_size):
            mat[i, x0[i]] += 1.0 - lam[i]
            mat[i, x1[i]] += lam[i]
    elif mode == "bicubic":
        x0 = np.floor(src).astype(np.int64)
        t = src - x0
        for off in (-1, 0, 1, 2):
            w = _cubic_weight(off - t)
            j = np.clip(x0 + off, 0, in_size - 1)
            for i in range(out_size):
                mat[i, j[i]] += w[i]
    else:
        raise ValueError(f"Unsupported mode: {mode}")
    return mat.astype(np.float32)


def resize_2d(
    x: torch.Tensor,
    size: Tuple[int, int],
    mode: str = "bilinear",
    antialias: bool = False,
    scale_factor: Optional[Tuple[float, float]] = None,
    channel_last: bool = True,
) -> torch.Tensor:
    """Resize the two spatial dims of ``x``: (..., H, W, C) if ``channel_last``
    else (..., H, W). With ``scale_factor`` the sampling uses 1/scale_factor
    (torch's rule) and ``size`` must be the resulting output size."""
    if channel_last:
        *lead, in_h, in_w, c = x.shape
    else:
        *lead, in_h, in_w = x.shape
    if (in_h, in_w) == tuple(size) and scale_factor is None:
        return x
    t = x.reshape(-1, in_h, in_w, c).permute(0, 3, 1, 2) if channel_last else x.reshape(-1, 1, in_h, in_w)
    kwargs = {} if mode == "nearest" else {"align_corners": False, "antialias": antialias}
    if scale_factor is not None:
        out = F.interpolate(t, scale_factor=tuple(scale_factor), mode=mode, **kwargs)
        if tuple(out.shape[-2:]) != tuple(size):
            raise ValueError(f"scale_factor {scale_factor} gives {tuple(out.shape[-2:])}, not {tuple(size)}")
    else:
        out = F.interpolate(t, size=tuple(size), mode=mode, **kwargs)
    out_h, out_w = out.shape[-2:]
    if channel_last:
        return out.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)
    return out.reshape(*lead, out_h, out_w)


def resize_image(image: torch.Tensor, size: Tuple[int, int], mode: Mode = "bilinear",
                 antialias: bool = False) -> torch.Tensor:
    """Resize a (..., H, W, C) image (NHWC, the convention throughout the package)."""
    return resize_2d(image, size, mode=mode, antialias=antialias, channel_last=True)
