"""Minimal OpenEXR codec (float32, uncompressed scanlines).

Writes single-part scanline EXR 2.0 files, FLOAT pixels, NO_COMPRESSION,
readable by any standard EXR implementation; reads the same subset (plus
HALF pixels), which covers the files it writes. A copy of the JAX package's
bundled codec (OpenCV builds often lack an EXR codec).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

_MAGIC = 20000630
_PIXELTYPE_HALF = 1
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


def read_exr(path: Union[str, Path]) -> Tuple[np.ndarray, List[str]]:
    """Read an uncompressed scanline EXR -> ((H, W, C) float32, channel names)."""
    buf = Path(path).read_bytes()
    magic, _version = struct.unpack_from("<Ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    pos = 8

    def read_cstr(p):
        end = buf.index(b"\0", p)
        return buf[p:end].decode(), end + 1

    attrs: Dict[str, Tuple[str, bytes]] = {}
    while buf[pos] != 0:
        name, pos = read_cstr(pos)
        type_, pos = read_cstr(pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (type_, buf[pos:pos + size])
        pos += size
    pos += 1

    comp = attrs["compression"][1][0]
    if comp != 0:
        raise ValueError(f"{path}: only NO_COMPRESSION EXRs are supported (compression {comp})")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    channels = []
    cbuf, cpos = attrs["channels"][1], 0
    while cbuf[cpos] != 0:
        end = cbuf.index(b"\0", cpos)
        name = cbuf[cpos:end].decode()
        (ptype,) = struct.unpack_from("<i", cbuf, end + 1)
        cpos = end + 1 + 4 + 4 + 8  # ptype, pLinear + reserved, sampling
        channels.append((name, ptype))

    pos += 8 * h  # the offset table
    out = np.zeros((h, len(channels), w), np.float32)
    for _ in range(h):
        y, size = struct.unpack_from("<ii", buf, pos)
        row = buf[pos + 8:pos + 8 + size]
        pos += 8 + size
        off = 0
        for j, (name, ptype) in enumerate(channels):
            if ptype == _PIXELTYPE_FLOAT:
                out[y - y0, j] = np.frombuffer(row, "<f4", count=w, offset=off)
                off += 4 * w
            elif ptype == _PIXELTYPE_HALF:
                out[y - y0, j] = np.frombuffer(row, "<f2", count=w, offset=off).astype(np.float32)
                off += 2 * w
            else:
                raise ValueError(f"{path}: unsupported pixel type {ptype}")
    return out.transpose(0, 2, 1), [name for name, _ in channels]
