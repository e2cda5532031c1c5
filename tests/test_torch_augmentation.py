"""The port's training augmentation (moge_tpu_torch.utils.data_augmentation
and the depth helpers of its geometry_numpy) against the JAX package's, on
the CPU: both are host numpy/cv2/PIL code, so with one cv2 and one Pillow
and the same ``np.random.default_rng`` seeds the outputs are equal, bit for
bit."""

import numpy as np
import pytest

from moge_tpu.utils import data_augmentation as jaug
from moge_tpu.utils import geometry_numpy as jgeo
from moge_tpu_torch.utils import data_augmentation as taug
from moge_tpu_torch.utils import geometry_numpy as tgeo

SEEDS = range(6)


def _intrinsics(fx=0.8, aspect=4 / 3):
    return np.array([[fx, 0, 0.5], [0, fx * aspect, 0.5], [0, 0, 1]], np.float32)


def _image(h=72, w=96, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / w
    base = 127 + 80 * np.sin(5 * xx[..., None] + 3 * yy[..., None] + rng.uniform(0, 6, 3))
    return np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)


def _depth(h=72, w=96, seed=0):
    rng = np.random.default_rng(seed + 100)
    yy, xx = np.mgrid[0:h, 0:w] / w
    depth = (2.0 + yy + 0.3 * np.sin(9 * xx) + 0.02 * rng.standard_normal((h, w))).astype(np.float32)
    depth[: h // 8] = np.inf
    depth[30:36, 40:50] = np.nan
    return depth


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("aspect,center,fov_rel", [(1.0, 0.5, (0.5, 1.0)), (2.0, 0.25, (0.01, 1.0)),
                                                  (0.5, 0.5, (0.75, 1.0))])
def test_sample_perspective_equals_jax(seed, aspect, center, fov_rel):
    args = (_intrinsics(), aspect, center, (1, 179), fov_rel)
    got = taug.sample_perspective(*args, rng=np.random.default_rng(seed))
    want = jaug.sample_perspective(*args, rng=np.random.default_rng(seed))
    assert all(_equal(g, w) for g, w in zip(got, want))


def _transform(seed, aspect):
    tgt, R = jaug.sample_perspective(_intrinsics(), aspect, 0.5, (1, 179), (0.5, 1.0), rng=np.random.default_rng(seed))
    return tgt @ R @ np.linalg.inv(_intrinsics())


@pytest.mark.parametrize("interp,tgt,src", [
    ("lanczos", (48, 64), "image"),      # shrinks: the PIL prefilter
    ("lanczos", (96, 128), "image"),     # enlarges: cv2 alone
    ("bilinear", (48, 64), "depth"),
    ("bilinear", (60, 60), "normal"),
    ("nearest", (48, 64), "depth"),
    ("nearest", (24, 32), "sparse"),     # the masked nearest downscale
])
def test_warp_perspective_equals_jax(interp, tgt, src):
    depth = _depth()
    src_map = {"image": _image(), "depth": 1 / depth, "sparse": depth,
               "normal": jgeo.depth_map_to_normal_map_numpy(depth, _intrinsics())[0]}[src]
    sparse = ~np.isnan(depth) if src == "sparse" else None
    transform = _transform(3, tgt[1] / tgt[0])
    with np.errstate(divide="ignore", invalid="ignore"):
        got = taug.warp_perspective(src_map, transform, tgt, interpolation=interp, sparse_mask=sparse)
        want = jaug.warp_perspective(src_map, transform, tgt, interpolation=interp, sparse_mask=sparse)
    assert _equal(got, want)


@pytest.mark.parametrize("branch", ["jittering", "dof", "shot_noise", "blurring", "jpeg_loss", "all"])
def test_image_color_augmentation_equals_jax(branch):
    """Each branch over seeds of which some take it (the draws < 0.5) and
    some do not; the image changes on at least one."""
    augs = ["jittering", "dof", "shot_noise", "blurring", "jpeg_loss"] if branch == "all" else [branch]
    image, depth = _image(), _depth()
    changed = 0
    for seed in SEEDS:
        got = taug.image_color_augmentation(image, augs, rng=np.random.default_rng(seed), depth=depth)
        want = jaug.image_color_augmentation(image, augs, rng=np.random.default_rng(seed), depth=depth)
        assert _equal(got, want), seed
        changed += not np.array_equal(got, image)
    assert changed


@pytest.mark.parametrize("edge_threshold", [None, 88])
def test_depth_map_to_normal_map_equals_jax(edge_threshold):
    depth = _depth()
    args = (depth, _intrinsics())
    got = tgeo.depth_map_to_normal_map_numpy(*args, mask=np.isfinite(depth), edge_threshold=edge_threshold)
    want = jgeo.depth_map_to_normal_map_numpy(*args, mask=np.isfinite(depth), edge_threshold=edge_threshold)
    assert all(_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("strength", [0, 5, 11])
def test_depth_of_field_equals_jax(strength):
    depth = np.nan_to_num(_depth(), nan=2.0, posinf=50.0)
    disp = (1 / depth).astype(np.float32)
    focus = float(np.median(disp))
    got = tgeo.depth_of_field(_image(), disp, focus, strength)
    want = jgeo.depth_of_field(_image(), disp, focus, strength)
    assert _equal(got, want)
    assert _equal(tgeo.disk_kernel(strength), jgeo.disk_kernel(strength))
