"""The port's host utilities (moge_tpu_torch/utils, the CLI's and the
server's writers and the EXR reader, geometry, mesh export and
colorization) against the JAX package's moge_tpu.utils on seeded inputs:
equal arrays and equal bytes; the profiler trace; the program's spans (off
without a profiler, counted and nested with one, on threads that started
before it, and ``infer``'s stages for MoGe-1 and MoGe-2)."""

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


def test_profile_trace_holds_the_spans_of_a_thread_started_before_it(tmp_path):
    import json
    import threading

    import torch

    from moge_tpu_torch.utils.tools import profile_trace, span, span_summary

    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait()
        with span("moge.test.worker"):
            torch.ones(32, 32) @ torch.ones(32, 32)
        done.set()

    thread = threading.Thread(target=worker)
    thread.start()
    with profile_trace(tmp_path / "trace") as trace:
        go.set()
        assert done.wait(60)
    thread.join()
    names = {e.get("name") for e in json.loads(trace.path.read_text())["traceEvents"]}
    assert "moge.test.worker" in names
    assert span_summary()["moge.test.worker"]["count"] == 1


def test_a_span_without_a_profiler_enters_no_range_and_stores_nothing(monkeypatch):
    import torch

    from moge_tpu_torch.utils import tools

    tools.span_summary()

    def no_range(*args, **kwargs):
        raise AssertionError("a range entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    with tools.span("moge.test.off", device=True), tools.span("moge.test.off.inner"):
        with tools.span("moge.test.off.bare", device=True, host_range=False):
            pass
    assert tools.span("a") is tools.span("b")  # one shared no-op context
    assert tools.span_summary() == {}


def test_span_summary_counts_nests_and_empties():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from moge_tpu_torch.utils.tools import span, span_summary

    span_summary()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with span("moge.test.outer", device=True):
                with span("moge.test.inner", args={"batch": 7}):
                    with span("moge.test.bare", device=True, host_range=False):
                        torch.ones(8) + 1
    summary = span_summary()
    assert summary["moge.test.outer"]["count"] == 3 and summary["moge.test.outer"]["parent"] is None
    assert summary["moge.test.inner"]["count"] == 3 and summary["moge.test.inner"]["parent"] == "moge.test.outer"
    assert summary["moge.test.bare"]["count"] == 3 and summary["moge.test.bare"]["parent"] == "moge.test.inner"
    assert summary["moge.test.outer"]["host_s"] >= summary["moge.test.inner"]["host_s"] >= \
        summary["moge.test.bare"]["host_s"] > 0
    assert summary["moge.test.outer"]["device_s"] == 0.0  # no CUDA in use: no events
    assert span_summary() == {}
    ranges = [e for e in prof.events() if e.name.startswith("moge.test.")]
    assert sorted({e.name for e in ranges}) == ["moge.test.inner", "moge.test.outer"]  # the bare span has no range
    outer = [e for e in ranges if e.name == "moge.test.outer"]
    for e in ranges:
        if e.name == "moge.test.inner":
            assert any(o.time_range.start <= e.time_range.start and e.time_range.end <= o.time_range.end
                       for o in outer)


def test_spans_from_many_threads_are_all_stored():
    import sys
    import threading

    from torch.profiler import ProfilerActivity, profile

    from moge_tpu_torch.utils.tools import span, span_summary

    span_summary()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            def worker():
                for _ in range(300):
                    with span("moge.test.thread"), span("moge.test.bare", host_range=False):
                        pass

            threads = [threading.Thread(target=worker) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    summary = span_summary()
    assert summary["moge.test.thread"]["count"] == summary["moge.test.bare"]["count"] == 16 * 300
    assert summary["moge.test.bare"]["parent"] == "moge.test.thread"


INFER_STAGES = {"moge.infer": None, "moge.upload": "moge.infer", "moge.resize": "moge.infer",
                "moge.encoder": "moge.infer", "moge.decoder": "moge.infer", "moge.post": "moge.infer",
                "moge.solve": "moge.post"}


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_infer_stages_are_spans(version):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from moge_tpu_torch.models import v1, v2
    from moge_tpu_torch.utils.tools import span_summary
    from torch_tiny_config import TINY_CONFIG

    if version == "v2":
        model = v2.MoGeModel(TINY_CONFIG, "cpu", torch.float32).init_random(seed=0)
    else:
        tiny_v1 = {"encoder": "dinov2_vitt14", "intermediate_layers": 4, "dim_proj": 32,
                   "dim_upsample": [32, 16, 16], "dim_times_res_block_hidden": 2, "num_res_blocks": 1,
                   "remap_output": "exp", "res_block_norm": "group_norm", "last_res_blocks": 1,
                   "last_conv_channels": 32, "last_conv_size": 1}
        model = v1.MoGeModel(tiny_v1, "cpu", torch.float32).init_random(seed=0)
    image = np.random.default_rng(0).uniform(0, 1, (2, 42, 56, 3)).astype(np.float32)
    want = model.infer(torch.from_numpy(image), num_tokens=12, use_fp16=False)
    span_summary()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            got = model.infer(torch.from_numpy(image), num_tokens=12, use_fp16=False)
    summary = span_summary()
    assert {name: summary[name]["parent"] for name in INFER_STAGES} == INFER_STAGES
    # the encoder and the decoder open no range: a range of the caller's around
    # them (the benchmark's pb.encoder, pb.decode) keeps the kernels it had
    ranges = {e.name for e in prof.events() if e.name.startswith("moge.")}
    assert ranges == set(INFER_STAGES) - {"moge.encoder", "moge.decoder"}
    assert all(summary[name]["count"] == 2 for name in INFER_STAGES)
    assert all(summary[name]["host_s"] <= summary["moge.infer"]["host_s"] for name in INFER_STAGES)
    for key, value in want.items():  # the spans change no answer
        assert torch.equal(got[key], value), key
