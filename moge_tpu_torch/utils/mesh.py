"""Mesh building over the pixel grid and GLB/PLY export, without trimesh
(reference moge/utils/io.py:18-63, moge/scripts/infer.py:126-156): a binary
little-endian PLY with vertex colors and normals, and a minimal glTF-2.0 GLB
with positions, uvs, triangle indices and an embedded PNG texture. Copies of
the JAX package's ``moge_tpu/utils/mesh.py`` functions.
"""

from __future__ import annotations

import json
import struct
from typing import Optional, Tuple

import numpy as np

__all__ = ["image_mesh_from_map", "save_ply", "save_glb"]


def image_mesh_from_map(
    *attributes: np.ndarray,
    mask: Optional[np.ndarray] = None,
    tri: bool = True,
) -> Tuple[np.ndarray, ...]:
    """Build a mesh over the pixel grid (utils3d `build_mesh_from_map`).

    Each (H, W, C) attribute is flattened to per-vertex data; faces connect
    each quad of adjacent pixels (two triangles if ``tri``), keeping only quads
    whose 4 corners are valid under ``mask``. Returns (faces, *vertex_attrs).
    """
    height, width = attributes[0].shape[:2]
    idx = np.arange(height * width).reshape(height, width)

    tl = idx[:-1, :-1].reshape(-1)
    tr = idx[:-1, 1:].reshape(-1)
    bl = idx[1:, :-1].reshape(-1)
    br = idx[1:, 1:].reshape(-1)
    quads = np.stack([tl, tr, br, bl], axis=-1)  # CCW in image space

    if mask is not None:
        m = mask.reshape(-1)
        keep = m[tl] & m[tr] & m[bl] & m[br]
        quads = quads[keep]

    verts = [a.reshape(-1, *a.shape[2:]) for a in attributes]
    # compact vertices to referenced ones
    used = np.unique(quads.reshape(-1))
    remap = np.full(height * width, -1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    quads = remap[quads]
    verts = [v[used] for v in verts]

    if tri:
        faces = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]], axis=0)
    else:
        faces = quads
    return (faces.astype(np.uint32), *verts)


def save_ply(
    save_path,
    vertices: np.ndarray,
    faces: np.ndarray,
    vertex_colors: Optional[np.ndarray] = None,
    vertex_normals: Optional[np.ndarray] = None,
):
    """Binary little-endian PLY (reference io.py:46-63 via trimesh)."""
    vertices = np.asarray(vertices, np.float32)
    n = len(vertices)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {c}" for c in "xyz"]
    cols = None
    if vertex_normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
    if vertex_colors is not None:
        cols = np.asarray(vertex_colors)
        if cols.dtype != np.uint8:
            cols = (np.clip(cols, 0, 1) * 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {len(faces)}", "property list uchar uint vertex_indices", "end_header"]

    with open(save_path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        fields = [vertices]
        if vertex_normals is not None:
            fields.append(np.asarray(vertex_normals, np.float32))
        float_block = np.concatenate(fields, axis=-1).astype("<f4")
        if cols is not None:
            rec = np.empty(n, dtype=[("f", "<f4", float_block.shape[1]), ("c", "u1", 3)])
            rec["f"], rec["c"] = float_block, cols[:, :3]
            f.write(rec.tobytes())
        else:
            f.write(float_block.tobytes())
        faces = np.asarray(faces, np.uint32)
        rec = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<u4", faces.shape[1])])
        rec["n"], rec["idx"] = faces.shape[1], faces
        f.write(rec.tobytes())


def save_glb(
    save_path,
    vertices: np.ndarray,
    faces: np.ndarray,
    vertex_uvs: np.ndarray,
    texture: np.ndarray,
    vertex_normals: Optional[np.ndarray] = None,
):
    """Minimal glTF-2.0 GLB with an embedded PNG texture (reference io.py:18-43)."""
    vertices = np.asarray(vertices, np.float32)
    vertex_uvs = np.asarray(vertex_uvs, np.float32)
    faces = np.asarray(faces, np.uint32)
    import cv2

    png = cv2.imencode(".png", cv2.cvtColor(texture, cv2.COLOR_RGB2BGR))[1].tobytes()

    def pad4(b: bytes, fill: bytes = b"\x00") -> bytes:
        return b + fill * ((4 - len(b) % 4) % 4)

    buffers = []
    views = []
    accessors = []

    def add_view(data: bytes, target=None):
        offset = sum(len(b) for b in buffers)
        buffers.append(pad4(data))
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if target:
            view["target"] = target
        views.append(view)
        return len(views) - 1

    if len(vertices) == 0:
        raise ValueError("save_glb requires at least one vertex")
    idx_view = add_view(faces.reshape(-1).astype("<u4").tobytes(), target=34963)
    accessors.append({
        "bufferView": idx_view, "componentType": 5125, "count": int(faces.size),
        "type": "SCALAR", "max": [int(faces.max()) if faces.size else 0], "min": [0],
    })
    pos_view = add_view(vertices.astype("<f4").tobytes(), target=34962)
    accessors.append({
        "bufferView": pos_view, "componentType": 5126, "count": int(len(vertices)),
        "type": "VEC3", "max": vertices.max(0).tolist(), "min": vertices.min(0).tolist(),
    })
    uv_view = add_view(vertex_uvs.astype("<f4").tobytes(), target=34962)
    accessors.append({
        "bufferView": uv_view, "componentType": 5126, "count": int(len(vertex_uvs)), "type": "VEC2",
    })
    attrs = {"POSITION": 1, "TEXCOORD_0": 2}
    if vertex_normals is not None:
        nrm_view = add_view(np.asarray(vertex_normals, "<f4").tobytes(), target=34962)
        accessors.append({
            "bufferView": nrm_view, "componentType": 5126, "count": int(len(vertex_normals)), "type": "VEC3",
        })
        attrs["NORMAL"] = len(accessors) - 1
    img_view = add_view(png)

    gltf = {
        "asset": {"version": "2.0", "generator": "moge_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attrs, "indices": 0, "material": 0}]}],
        "materials": [{
            "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "metallicFactor": 0.5,
                "roughnessFactor": 1.0,
            },
            "doubleSided": True,
        }],
        "textures": [{"source": 0, "sampler": 0}],
        "samplers": [{"magFilter": 9729, "minFilter": 9987, "wrapS": 10497, "wrapT": 10497}],
        "images": [{"bufferView": img_view, "mimeType": "image/png"}],
        "bufferViews": views,
        "accessors": accessors,
        "buffers": [{"byteLength": sum(len(b) for b in buffers)}],
    }

    json_chunk = pad4(json.dumps(gltf, separators=(",", ":")).encode("utf-8"), b" ")
    bin_chunk = b"".join(buffers)
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    with open(save_path, "wb") as f:
        f.write(struct.pack("<4sII", b"glTF", 2, total))
        f.write(struct.pack("<I4s", len(json_chunk), b"JSON"))
        f.write(json_chunk)
        f.write(struct.pack("<I4s", len(bin_chunk), b"BIN\x00"))
        f.write(bin_chunk)
