"""The port's host utilities (moge_tpu_torch/utils, the CLI's and the
server's writers and the EXR reader, geometry, mesh export and
colorization) against the JAX package's moge_tpu.utils on seeded inputs:
equal arrays and equal bytes; and the profiler trace."""

import io

import numpy as np
import pytest

from moge_tpu.utils import exr as jexr
from moge_tpu.utils import geometry_numpy as jgeo
from moge_tpu.utils import io as jio
from moge_tpu.utils import mesh as jmesh
from moge_tpu.utils import vis as jvis
from moge_tpu_torch.utils import exr
from moge_tpu_torch.utils import geometry_numpy as geo
from moge_tpu_torch.utils import io as pio
from moge_tpu_torch.utils import mesh
from moge_tpu_torch.utils import vis


def _maps(seed=0, h=13, w=17):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 4.0, (h, w)).astype(np.float32)
    depth[2, 3], depth[5, 6] = np.nan, np.inf
    normal = rng.standard_normal((h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[1, 1] = np.nan
    points = rng.standard_normal((h, w, 3)).astype(np.float32)
    image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    mask = rng.uniform(0, 1, (h, w)) > 0.2
    return depth, normal, points, image, mask


def test_geometry_matches():
    intr = np.random.default_rng(1).uniform(0.3, 2.0, (4, 3, 3))
    for a, b in zip(geo.intrinsics_to_fov_numpy(intr), jgeo.intrinsics_to_fov_numpy(intr)):
        assert np.array_equal(a, b)
    assert np.array_equal(geo.uv_map_numpy(7, 11), jgeo.uv_map_numpy(7, 11))


def test_depth_edge_matches():
    pytest.importorskip("cv2")
    depth, *_ = _maps()
    depth = np.nan_to_num(depth, nan=1.0, posinf=9.0)
    for kw in ({}, {"rtol": 0.2}, {"ltol": 0.3, "rtol": None}):
        assert np.array_equal(geo.depth_map_edge_numpy(depth, **kw), jgeo.depth_map_edge_numpy(depth, **kw))


def test_colorizations_match():
    depth, normal, *_ = _maps()
    assert np.array_equal(vis.colorize_depth(depth), jvis.colorize_depth(depth))
    finite = np.nan_to_num(normal)  # a NaN's cast to uint8 is undefined
    assert np.array_equal(vis.colorize_normal(finite), jvis.colorize_normal(finite))
    mask = np.isfinite(depth)
    assert np.array_equal(vis.colorize_depth(depth, mask), jvis.colorize_depth(depth, mask))


def test_mesh_arrays_and_files_match(tmp_path):
    depth, normal, points, image, mask = _maps()
    attrs = [points, image.astype(np.float32) / 255, geo.uv_map_numpy(*depth.shape), normal]
    got, want = mesh.image_mesh_from_map(*attrs, mask=mask), jmesh.image_mesh_from_map(*attrs, mask=mask)
    assert len(got) == len(want) and all(np.array_equal(a, b, equal_nan=True) for a, b in zip(got, want))
    faces, vertices, colors, uvs, normals = got
    mesh.save_ply(tmp_path / "a.ply", vertices, faces, colors, normals)
    jmesh.save_ply(tmp_path / "b.ply", vertices, faces, colors, normals)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    pytest.importorskip("cv2")
    mesh.save_glb(tmp_path / "a.glb", vertices, faces, uvs, image, normals)
    jmesh.save_glb(tmp_path / "b.glb", vertices, faces, uvs, image, normals)
    assert (tmp_path / "a.glb").read_bytes() == (tmp_path / "b.glb").read_bytes()


def test_written_maps_match(tmp_path):
    depth, normal, points, *_ = _maps()
    pio.write_exr(tmp_path / "a.exr", points)
    jio.write_exr(tmp_path / "b.exr", points)
    assert (tmp_path / "a.exr").read_bytes() == (tmp_path / "b.exr").read_bytes()
    pio.write_exr(tmp_path / "c.exr", depth)
    assert np.array_equal(jio.read_exr(tmp_path / "c.exr"), depth, equal_nan=True)
    got, want = io.BytesIO(), io.BytesIO()
    pio.write_depth(got, depth)
    jio.write_depth(want, depth)
    assert got.getvalue() == want.getvalue()
    pytest.importorskip("cv2")
    got, want = io.BytesIO(), io.BytesIO()
    pio.write_normal(got, normal)
    jio.write_normal(want, normal)
    assert got.getvalue() == want.getvalue()


def test_read_exr_round_trips_and_reads_jaxs_files(tmp_path):
    """Channels come back in the file's (sorted) order, with their names, as in JAX's reader."""
    depth, _, points, *_ = _maps()
    pio.write_exr(tmp_path / "depth.exr", depth)
    assert np.array_equal(pio.read_exr(tmp_path / "depth.exr"), depth, equal_nan=True)
    pio.write_exr(tmp_path / "points.exr", points)
    data, names = exr.read_exr(tmp_path / "points.exr")
    assert names == ["B", "G", "R"] and np.array_equal(data, points[..., ::-1], equal_nan=True)
    for name, data in (("depth", depth), ("points", points)):
        jio.write_exr(tmp_path / f"{name}_jax.exr", data)
        assert np.array_equal(pio.read_exr(tmp_path / f"{name}_jax.exr"), jio.read_exr(tmp_path / f"{name}_jax.exr"),
                              equal_nan=True)
    four = np.random.default_rng(2).standard_normal((5, 6, 4)).astype(np.float32)
    jexr.write_exr(tmp_path / "named.exr", four, ["Z", "A", "Y", "B"])
    got, want = exr.read_exr(tmp_path / "named.exr"), jexr.read_exr(tmp_path / "named.exr")
    assert got[1] == want[1] == ["A", "B", "Y", "Z"] and np.array_equal(got[0], want[0])


def test_segmentation_and_error_colorizations_match():
    rng = np.random.default_rng(3)
    segmentation = rng.integers(0, 50, (13, 17))
    assert np.array_equal(vis.colorize_segmentation(segmentation), jvis.colorize_segmentation(segmentation))
    error = rng.uniform(0, 2, (13, 17)).astype(np.float32)
    error[0, 0] = np.nan
    mask = rng.uniform(0, 1, (13, 17)) > 0.3
    for kwargs in ({}, {"mask": mask}, {"value_range": (0.2, 1.5), "cmap": "viridis"}):
        assert np.array_equal(vis.colorize_error_map(error, **kwargs), jvis.colorize_error_map(error, **kwargs))


def test_numpy_means_uv_and_occlusion_edges_match():
    depth, *_, mask = _maps()
    depth = np.nan_to_num(depth, nan=1.0, posinf=9.0)
    x = np.random.default_rng(4).uniform(0.1, 3, (4, 13, 17)).astype(np.float32)
    w = np.random.default_rng(5).uniform(0, 1, (4, 13, 17)) > 0.4
    for fn in ("weighted_mean_numpy", "harmonic_mean_numpy"):
        for kwargs in ({}, {"w": w}, {"w": w, "axis": (-2, -1), "keepdims": True}):
            assert np.array_equal(getattr(geo, fn)(x, **kwargs), getattr(jgeo, fn)(x, **kwargs)), (fn, kwargs)
    for args in ((17, 13), (13, 17, 2.0)):
        assert np.array_equal(geo.normalized_view_plane_uv_numpy(*args), jgeo.normalized_view_plane_uv_numpy(*args))
    pytest.importorskip("cv2")
    for kwargs in ({}, {"thickness": 2, "tol": 0.05}):
        got = geo.depth_occlusion_edge_numpy(depth, mask, **kwargs)
        assert np.array_equal(got, jgeo.depth_occlusion_edge_numpy(depth, mask, **kwargs)) and got.any()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    import json

    import torch

    from moge_tpu_torch.utils.tools import profile_trace

    with profile_trace(tmp_path / "trace") as trace:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads(trace.path.read_text())["traceEvents"]
    assert trace.path == tmp_path / "trace" / "trace.json"
    assert any("mm" in str(e.get("name", "")) for e in events)
