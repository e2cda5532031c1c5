"""Image resampling (port of moge_tpu/ops/resize.py).

The JAX package builds its resampling matrices to reproduce
``torch.nn.functional.interpolate`` exactly, so the port calls
``F.interpolate`` itself, in the flavours inference uses: antialiased
bilinear (input resize), plain bilinear (output epilogue), legacy nearest
(the solver's downsample and the ``nearest`` resampler), bicubic with a
``scale_factor`` (the DINOv2 pos-embed interpolation) and antialiased
bicubic to a size (MoGe-1's input resize).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["resize_2d"]


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
