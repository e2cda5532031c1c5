"""Minimal OpenEXR writer (float32, uncompressed scanlines).

Single-part scanline EXR 2.0 files, FLOAT pixels, NO_COMPRESSION, readable by
any standard EXR implementation (a copy of the writer of the JAX package's
bundled codec; OpenCV builds often lack an EXR codec).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Union

import numpy as np

_MAGIC = 20000630
_PIXELTYPE_FLOAT = 2


def _attr(name: str, type_: str, value: bytes) -> bytes:
    return name.encode() + b"\0" + type_.encode() + b"\0" + struct.pack("<i", len(value)) + value


def write_exr(path: Union[str, Path], data: np.ndarray, channel_names: List[str] = None):
    """Write (H, W) or (H, W, C) float32 data as an uncompressed EXR."""
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data[..., None]
    h, w, c = data.shape
    if channel_names is None:
        channel_names = ["Y"] if c == 1 else (["R", "G", "B"][:c] if c <= 3 else [f"C{i}" for i in range(c)])
    assert len(channel_names) == c

    # channels must be stored sorted by name
    order = sorted(range(c), key=lambda i: channel_names[i])
    sorted_names = [channel_names[i] for i in order]

    chlist = b""
    for name in sorted_names:
        chlist += name.encode() + b"\0"
        chlist += struct.pack("<i", _PIXELTYPE_FLOAT)
        chlist += struct.pack("<BBBB", 0, 0, 0, 0)  # pLinear + reserved
        chlist += struct.pack("<ii", 1, 1)  # x/y sampling
    chlist += b"\0"

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join([
        _attr("channels", "chlist", chlist),
        _attr("compression", "compression", struct.pack("<B", 0)),
        _attr("dataWindow", "box2i", box),
        _attr("displayWindow", "box2i", box),
        _attr("lineOrder", "lineOrder", struct.pack("<B", 0)),
        _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
        _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
        b"\0",
    ])

    preamble = struct.pack("<Ii", _MAGIC, 2) + header
    table_start = len(preamble)
    data_start = table_start + 8 * h
    row_bytes = 8 + c * w * 4  # y + size prefix + pixel data
    offsets = [data_start + i * row_bytes for i in range(h)]

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(struct.pack(f"<{h}Q", *offsets))
        ordered = np.ascontiguousarray(data[:, :, order].transpose(0, 2, 1))  # (H, C, W)
        for y in range(h):
            f.write(struct.pack("<ii", y, c * w * 4))
            f.write(ordered[y].astype("<f4").tobytes())
