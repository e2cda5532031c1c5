"""Depth, normal and EXR writers, file-format compatible with the reference
(moge/utils/io.py): log-scale 16-bit PNG depth with near/far PNG text
metadata (0 = NaN, 65535 = Inf), 16-bit normal PNG with the [2, -2, -2]
mapping. Copies of the JAX package's ``moge_tpu/utils/io.py`` writers."""

from __future__ import annotations

import os
from pathlib import Path
from typing import IO, Union

import numpy as np

__all__ = ["write_depth", "write_normal", "write_exr"]

PathOrIO = Union[str, os.PathLike, IO]


def _write_bytes(path: PathOrIO, data: bytes):
    if isinstance(path, (str, os.PathLike)):
        Path(path).write_bytes(data)
    else:
        path.write(data)


def write_depth(path: PathOrIO, depth: np.ndarray, max_range: float = 1e5, compression_level: int = 7):
    """Log-scale 16-bit PNG: value = near^(1-d) * far^d (reference io.py:112-150)."""
    from PIL import Image, PngImagePlugin

    mask_values, mask_nan, mask_inf = np.isfinite(depth), np.isnan(depth), np.isinf(depth)
    depth = depth.astype(np.float32)
    near = max(depth[mask_values].min(), 1e-5)
    far = max(near * 1.1, min(depth[mask_values].max(), near * max_range))
    encoded = 1 + np.round(
        (np.log(np.nan_to_num(depth, nan=0).clip(near, far) / near) / np.log(far / near)).clip(0, 1) * 65533
    ).astype(np.uint16)
    encoded[mask_nan] = 0
    encoded[mask_inf] = 65535

    pil_image = Image.fromarray(encoded)
    pnginfo = PngImagePlugin.PngInfo()
    pnginfo.add_text("near", str(near))
    pnginfo.add_text("far", str(far))
    # explicit format: ``path`` may be a file object with no extension
    pil_image.save(path, format="PNG", pnginfo=pnginfo, compress_level=compression_level)


def write_normal(path: PathOrIO, normal: np.ndarray, compression_level: int = 7):
    """16-bit PNG of (H, W, 3) unit normals; NaN normals are written as 0."""
    import cv2

    mask_nan = np.isnan(normal).any(axis=-1)
    encoded = ((normal * [0.5, -0.5, -0.5] + 0.5).clip(0, 1) * 65535).astype(np.uint16)
    encoded[mask_nan] = 0
    data = cv2.imencode(
        ".png", cv2.cvtColor(encoded, cv2.COLOR_RGB2BGR), [cv2.IMWRITE_PNG_COMPRESSION, compression_level]
    )[1].tobytes()
    _write_bytes(path, data)


def write_exr(path: Union[str, os.PathLike], data: np.ndarray):
    """Write float32 data as an uncompressed EXR (``exr.write_exr``)."""
    from .exr import write_exr as _write

    _write(path, np.asarray(data, np.float32))
