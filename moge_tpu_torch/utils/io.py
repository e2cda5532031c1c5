"""Image, depth, normal, segmentation, mask, JSON and EXR codecs,
file-format compatible with the reference (moge/utils/io.py): log-scale
16-bit PNG depth with near/far PNG text metadata (0 = NaN, 65535 = Inf),
16-bit normal PNG with the [2, -2, -2] mapping, segmentation PNG with its
JSON labels in the metadata. Copies of the JAX package's
``moge_tpu/utils/io.py``; cv2 and PIL are imported inside the functions."""

from __future__ import annotations

import io
import json
import os
from pathlib import Path
from typing import IO, Dict, Optional, Tuple, Union

import numpy as np

__all__ = ["read_image", "write_image", "read_depth", "write_depth", "read_segmentation", "write_segmentation",
           "read_normal", "write_normal", "read_mask", "write_mask", "read_json", "write_json",
           "write_exr"]

PathOrIO = Union[str, os.PathLike, IO]


def _read_bytes(path: PathOrIO) -> bytes:
    if isinstance(path, (str, os.PathLike)):
        return Path(path).read_bytes()
    return path.read()


def _write_bytes(path: PathOrIO, data: bytes):
    if isinstance(path, (str, os.PathLike)):
        Path(path).write_bytes(data)
    else:
        path.write(data)


def read_image(path: PathOrIO) -> np.ndarray:
    """uint8 RGB (H, W, 3)."""
    import cv2

    data = _read_bytes(path)
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def write_image(path: PathOrIO, image: np.ndarray, quality: int = 95):
    import cv2

    data = cv2.imencode(".jpg", cv2.cvtColor(image, cv2.COLOR_RGB2BGR), [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
    _write_bytes(path, data)


def read_depth(path: PathOrIO) -> np.ndarray:
    """float32 (H, W) depth; NaN invalid, Inf sky (reference io.py:89-109)."""
    from PIL import Image

    pil_image = Image.open(io.BytesIO(_read_bytes(path)))
    near = float(pil_image.info.get("near"))
    far = float(pil_image.info.get("far"))
    depth = np.array(pil_image)
    mask_nan, mask_inf = depth == 0, depth == 65535
    depth = (depth.astype(np.float32) - 1) / 65533
    depth = near ** (1 - depth) * far ** depth
    if "unit" in pil_image.info:  # legacy depth units
        depth = depth * float(pil_image.info.get("unit"))
    depth[mask_nan] = np.nan
    depth[mask_inf] = np.inf
    return depth


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


def read_segmentation(path: PathOrIO) -> Tuple[np.ndarray, Optional[Dict[str, int]]]:
    from PIL import Image

    pil_image = Image.open(io.BytesIO(_read_bytes(path)))
    labels = json.loads(pil_image.info["labels"]) if "labels" in pil_image.info else None
    return np.array(pil_image), labels


def write_segmentation(path: PathOrIO, mask: np.ndarray, labels: Optional[Dict[str, int]] = None,
                       compression_level: int = 7):
    from PIL import Image, PngImagePlugin

    assert mask.dtype in (np.uint8, np.uint16), f"Unsupported dtype {mask.dtype}"
    pil_image = Image.fromarray(mask)
    pnginfo = PngImagePlugin.PngInfo()
    if labels is not None:
        pnginfo.add_text("labels", json.dumps(labels, ensure_ascii=True, separators=(",", ":")))
    # explicit format: ``path`` may be a file object with no extension
    pil_image.save(path, format="PNG", pnginfo=pnginfo, compress_level=compression_level)


def read_normal(path: PathOrIO) -> np.ndarray:
    """float32 (H, W, 3) unit normals, NaN where invalid (reference io.py:198-225)."""
    import cv2

    normal = cv2.cvtColor(
        cv2.imdecode(np.frombuffer(_read_bytes(path), np.uint8), cv2.IMREAD_UNCHANGED), cv2.COLOR_BGR2RGB
    )
    mask_nan = np.all(normal == 0, axis=-1)
    normal = (normal.astype(np.float32) / 65535 - 0.5) * [2.0, -2.0, -2.0]
    normal = normal / (np.linalg.norm(normal, axis=-1, keepdims=True) + 1e-12)
    normal[mask_nan] = np.nan
    return normal


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


def read_mask(path: PathOrIO) -> np.ndarray:
    import cv2

    mask = cv2.imdecode(np.frombuffer(_read_bytes(path), np.uint8), cv2.IMREAD_UNCHANGED)
    if mask.ndim == 3:
        mask = mask[..., 0]
    return mask > 0


def write_mask(path: PathOrIO, mask: np.ndarray, compression_level: int = 7):
    import cv2

    assert mask.dtype == bool, f"Mask must be bool array, got {mask.dtype}"
    data = cv2.imencode(".png", mask.astype(np.uint8) * 255, [cv2.IMWRITE_PNG_COMPRESSION, compression_level])[1].tobytes()
    _write_bytes(path, data)


def read_json(path: PathOrIO):
    if isinstance(path, (str, os.PathLike)):
        return json.loads(Path(path).read_text())
    return json.loads(path.read())


def write_json(path: PathOrIO, content):
    text = json.dumps(content)
    if isinstance(path, (str, os.PathLike)):
        Path(path).write_text(text)
    else:
        path.write(text)


def read_exr(path: Union[str, os.PathLike]) -> np.ndarray:
    """Read a float EXR -> (H, W) or (H, W, C) float32 (``exr.read_exr``)."""
    from .exr import read_exr as _read

    data, _names = _read(path)
    return data[..., 0] if data.shape[-1] == 1 else data


def write_exr(path: Union[str, os.PathLike], data: np.ndarray):
    """Write float32 data as an uncompressed EXR (``exr.write_exr``)."""
    from .exr import write_exr as _write

    _write(path, np.asarray(data, np.float32))
