"""The port's eval harness (moge_tpu_torch.eval, utils.io, utils.pipeline)
against the JAX package's on the CPU: the codecs each way, the loader's
samples on the synthetic benchmark of tests/test_eval_e2e.py (written by the
port's codecs), and ``compute_metrics`` on three seeded pred/gt cases (the
JAX side computed once per module: it takes tens of seconds per call on a
CPU, its solves padded to 4096 entries)."""

import inspect
import json

import numpy as np
import pytest
import torch

from moge_tpu.eval.dataloader import EvalDataLoaderPipeline as JaxLoader
from moge_tpu.eval.metrics import compute_metrics as jax_compute_metrics
from moge_tpu.utils import io as jio
from moge_tpu_torch.eval import metrics
from moge_tpu_torch.eval.dataloader import EvalDataLoaderPipeline
from moge_tpu_torch.utils import io as tio
from moge_tpu_torch.utils.tools import flatten_nested_dict, key_average, unflatten_nested_dict
from torch_tiny_config import write_benchmark

torch.set_num_threads(1)

METRIC_RTOL = 1e-5  # fp32 solves in another order; boundary F1 is compared exactly
# the disparity class's 2x2 normal equations in fp32 lose ~4 digits to
# cancellation: on these cases JAX's (a, b) is 1-4e-5 off the fp64 solution,
# which the port computes, so their metrics part by up to ~3e-5
DISPARITY_RTOL = 1e-4
IMAGE_LEVEL = 1 / 255 + 1e-6  # one uint8 level of the [0, 1] image


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    write_benchmark(root)
    return root


def _config(root, **kwargs):
    return dict(path=str(root), width=80, height=60, depth_unit=1.0, has_sharp_boundary=True,
                include_segmentation=True, min_seg_area=100, num_load_workers=2, num_process_workers=2, **kwargs)


def _load(loader_cls, root):
    with loader_cls(**_config(root)) as pipe:
        return [pipe.get() for _ in range(len(pipe))]


@pytest.fixture(scope="module")
def samples(bench):
    return _load(EvalDataLoaderPipeline, bench)


def test_codecs_round_trip_with_jax(tmp_path):
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    depth = rng.uniform(0.5, 20, (24, 32)).astype(np.float32)
    depth[0, :3] = np.inf
    depth[1, :2] = np.nan
    seg = rng.integers(0, 4, (24, 32)).astype(np.uint16)
    labels = {"a": 0, "b": 3}
    mask = rng.uniform(0, 1, (24, 32)) > 0.5
    normal = rng.normal(0, 1, (24, 32, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    for writer, reader in ((tio, jio), (jio, tio)):
        d = tmp_path / writer.__name__.split(".")[0]
        d.mkdir()
        writer.write_image(d / "i.jpg", image)
        writer.write_depth(d / "d.png", depth)
        writer.write_segmentation(d / "s.png", seg, labels)
        writer.write_mask(d / "m.png", mask)
        writer.write_normal(d / "n.png", normal)
        writer.write_json(d / "j.json", {"k": [1, 2]})
        np.testing.assert_array_equal(reader.read_image(d / "i.jpg"), jio.read_image(d / "i.jpg"))
        got = reader.read_depth(d / "d.png")
        np.testing.assert_array_equal(got, jio.read_depth(d / "d.png"))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(depth))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(depth))
        fin = np.isfinite(depth)
        np.testing.assert_allclose(got[fin], depth[fin], rtol=1e-3)  # 16-bit log code
        got_seg, got_labels = reader.read_segmentation(d / "s.png")
        np.testing.assert_array_equal(got_seg, seg)
        assert got_labels == labels
        np.testing.assert_array_equal(reader.read_mask(d / "m.png"), mask)
        np.testing.assert_allclose(reader.read_normal(d / "n.png"), normal, atol=1e-4)
        assert reader.read_json(d / "j.json") == {"k": [1, 2]}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_loader_matches_jax(bench, samples, writer, tmp_path):
    """Both loaders on the benchmark written by the port's codecs, and on
    tests/test_eval_e2e.py's ``_write_benchmark`` (the JAX package's
    codecs, the same data)."""
    if writer == "jax":
        from test_eval_e2e import _write_benchmark

        _write_benchmark(tmp_path)
        bench, samples = tmp_path, _load(EvalDataLoaderPipeline, tmp_path)
    want = _load(JaxLoader, bench)
    assert [s["filename"] for s in samples] == [s["filename"] for s in want] == ["sample_0", "sample_1", "sample_2"]
    for got, ref in zip(samples, want):
        assert set(got) == set(ref)
        np.testing.assert_allclose(got["image"], ref["image"], atol=IMAGE_LEVEL)
        for key in ("depth", "depth_mask", "depth_mask_inf", "points", "intrinsics", "segmentation_mask"):
            if key in ref:
                assert got[key].dtype == ref[key].dtype, key
                np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        for key in ("segmentation_labels", "is_metric", "has_sharp_boundary", "width", "height"):
            assert got.get(key) == ref.get(key), key
    assert "segmentation_mask" in samples[1] and samples[0]["depth_mask_inf"][:5, :5].all()


def _cases(samples):
    """(name, pred, gt): v2 metric outputs with one segment (each segment
    adds a solve that costs JAX ~17 s on this CPU), v1 scale-invariant
    outputs, affine-invariant disparity alone. The first two keep a seeded
    half of the ground truth's pixels, as a LiDAR benchmark's sparse depth
    (the port's CPU solves cost the square of the points kept; JAX's do
    not, padded to 4096)."""
    rng = np.random.default_rng(1)
    out = []
    keep = rng.uniform(0, 1, samples[0]["depth_mask"].shape) < 0.5
    v2_gt = dict(samples[1], depth_mask=samples[1]["depth_mask"] & keep,
                 segmentation_labels={"floor": samples[1]["segmentation_labels"]["floor"]})
    v1_gt = dict(samples[0], depth_mask=samples[0]["depth_mask"] & keep)
    for name, gt in (("v2_metric", v2_gt), ("v1_scale_invariant", v1_gt), ("disparity", samples[2])):
        noise = rng.uniform(0.9, 1.1, gt["depth"].shape).astype(np.float32)
        depth = gt["depth"] * noise + 0.1
        points = gt["points"] * 1.05 + rng.normal(0, 0.01, gt["points"].shape).astype(np.float32)
        intrinsics = gt["intrinsics"] * np.array([[1.1, 1, 1], [1, 1.1, 1], [1, 1, 1]], np.float32)
        if name == "v2_metric":
            pred = {"depth_metric": depth, "points_metric": points, "intrinsics": intrinsics}
        elif name == "v1_scale_invariant":
            pred = {"depth_scale_invariant": depth * 0.3, "points_scale_invariant": points * 0.3,
                    "intrinsics": intrinsics}
        else:
            pred = {"disparity_affine_invariant": 2.0 / depth + 0.05}
        out.append((name, pred, gt))
    return out


@pytest.fixture(scope="module")
def jax_metrics(samples):
    return {name: jax_compute_metrics(pred, gt, vis=True) for name, pred, gt in _cases(samples)}


@pytest.mark.parametrize("case", ["v2_metric", "v1_scale_invariant", "disparity"])
def test_compute_metrics_matches_jax(samples, jax_metrics, case):
    name, pred, gt = next(c for c in _cases(samples) if c[0] == case)
    metrics.SOLVES.clear()
    got, misc = metrics.compute_metrics(pred, gt, vis=True, device="cpu")
    assert metrics.SOLVES["cpu"] > 0 and set(metrics.SOLVES) == {"cpu"}
    want, want_misc = jax_metrics[name]
    flat, flat_want = flatten_nested_dict(got), flatten_nested_dict(want)
    assert flat.keys() == flat_want.keys()
    expect = {"v2_metric": {"depth_metric", "points_metric", "local_points", "fov_x", "boundary"},
              "v1_scale_invariant": {"depth_scale_invariant", "points_affine_invariant", "fov_x"},
              "disparity": {"disparity_affine_invariant", "boundary"}}[case]
    assert expect <= set(got)
    for key, value in flat_want.items():
        if key[0] == "boundary" and case == "disparity":
            # its aligned depth carries the lstsq's drift, which can flip a
            # label at a threshold: the F1 itself is held exactly on JAX's
            # aligned depth, the depth to DISPARITY_RTOL below
            radius = int(key[1][len("radius"):-len("_f1")])
            assert metrics.boundary_f1(want_misc["pred_depth"], gt["depth"], gt["depth_mask"], radius) == value
        elif key[0] == "boundary":
            assert flat[key] == value, key
        else:
            rtol = DISPARITY_RTOL if key[0] == "disparity_affine_invariant" else METRIC_RTOL
            np.testing.assert_allclose(flat[key], value, rtol=rtol, err_msg=str(key))
    assert misc.keys() == want_misc.keys()
    rtol = DISPARITY_RTOL if case == "disparity" else METRIC_RTOL  # its maps come from the disparity solve
    for key in misc:
        np.testing.assert_allclose(misc[key], want_misc[key], rtol=rtol, err_msg=key)


def test_compute_metrics_defaults_to_the_card():
    assert inspect.signature(metrics.compute_metrics).parameters["device"].default == "cuda"


def test_nested_dict_tools():
    d = {"a": {"rel": 1.0, "delta1": 0.5}, "b": 2.0}
    assert unflatten_nested_dict(flatten_nested_dict(d)) == d
    avg = key_average([d, {"a": {"rel": 3.0, "delta1": float("nan")}}])
    assert avg == {"a": {"rel": 2.0, "delta1": 0.5}, "b": 2.0}
    assert json.loads(json.dumps(avg)) == avg
