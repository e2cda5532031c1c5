"""The port's public ops library (``moge_tpu_torch.ops``) against the JAX
package's ``moge_tpu.ops``: the 18 geometry functions that the port's
inference path does not itself use, ``resize_image`` and ``resize_matrix``,
and the re-exported names. Seeded numpy inputs, fp32 on both sides, held
at rtol 1e-5 / atol 1e-6 (the legacy closed-form solve at 1e-4: its fp32
normal equations lose digits in both packages, see its test);
``resize_matrix`` bit for bit; edge masks equal (the normal edges except
at pixels within 1e-5 of the threshold: none on these inputs, which the
test asserts)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import moge_tpu.ops as jops
import moge_tpu_torch.ops as tops

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
BAND = 1e-5  # edge pixels this close to their threshold may go either way


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _intrinsics(rng, n):
    f = rng.uniform(0.6, 1.6, (n, 2))
    c = rng.uniform(0.4, 0.6, (n, 2))
    k = np.zeros((n, 3, 3), np.float32)
    k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2], k[:, 2, 2] = f[:, 0], f[:, 1], c[:, 0], c[:, 1], 1.0
    return k


def _depth(rng, b=2, h=24, w=31):
    """Smooth positive depth with a step (occlusion edges) per image."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    d = 2.0 + 0.5 * np.sin(3 * xx[None] + rng.uniform(0, 3, (b, 1, 1))) + 0.3 * yy[None]
    d = d + np.where(xx[None] > 0.6, 1.5, 0.0) + rng.uniform(0, 0.02, (b, h, w))
    return d.astype(np.float32)


def test_focal_fov_and_intrinsics():
    rng = np.random.default_rng(0)
    focal = rng.uniform(0.3, 3.0, (5,)).astype(np.float32)
    fov = rng.uniform(0.3, 2.5, (5,)).astype(np.float32)
    _close(tops.focal_to_fov(*_t(focal)), jops.focal_to_fov(*_j(focal)))
    _close(tops.fov_to_focal(*_t(fov)), jops.fov_to_focal(*_j(fov)))
    fov_y = rng.uniform(0.3, 2.5, (5,)).astype(np.float32)
    for fx, fy in ((fov, None), (None, fov_y), (fov, fov_y)):
        got = tops.intrinsics_from_fov(*_t(fx, fy))
        _close(got, jops.intrinsics_from_fov(*_j(fx, fy)))
    _close(tops.intrinsics_from_fov(0.9), jops.intrinsics_from_fov(0.9))  # a number: float32, as jnp makes it
    k = _intrinsics(rng, 4)
    _close(tops.intrinsics_to_fov(*_t(k)), jops.intrinsics_to_fov(*_j(k)))


def test_project_and_unproject():
    rng = np.random.default_rng(1)
    k = _intrinsics(rng, 2)
    uv = rng.uniform(0, 1, (2, 50, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 5, (2, 50)).astype(np.float32)
    points = tops.unproject_cv(*_t(uv, depth, k))
    _close(points, jops.unproject_cv(*_j(uv, depth, k)))
    _close(tops.project_cv(points, *_t(k)), jops.project_cv(jnp.asarray(points.numpy()), *_j(k)))


def test_point_map_to_depth_legacy():
    """The closed-form focal/shift of a slanted plane's affine point map.
    Its 2x2 normal equations, summed over the map's 1488 rows in fp32, lose
    digits in both packages alike (each sits 1-5e-5 from a float64 solve
    here, more on a flatter scene), so this one is held at 1e-4 relative to
    each output's largest entry: against JAX, and against the same solve in
    float64."""
    rng = np.random.default_rng(2)
    yy, xx = np.meshgrid(np.linspace(0, 1, 24), np.linspace(0, 1, 31), indexing="ij")
    depth = (1.0 + 4.0 * xx + 2.0 * yy + rng.uniform(0, 0.02, (2, 24, 31))).astype(np.float32)
    points = np.asarray(jops.depth_map_to_point_map(*_j(depth, _intrinsics(rng, 2))))
    points = points - np.asarray([0, 0, 0.7], np.float32)  # an affine map the solve shifts back
    got = tops.point_map_to_depth_legacy(*_t(points))
    exact = tops.point_map_to_depth_legacy(torch.from_numpy(points).double())
    for g, j, e in zip(got, jops.point_map_to_depth_legacy(*_j(points)), exact):
        assert g.dtype == torch.float32 and g.shape == np.shape(j)
        for ref in (np.asarray(j, np.float64), e.numpy()):
            assert np.abs(g.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dim", [None, -1, (-2, -1)])
def test_geometric_mean(weighted, dim):
    rng = np.random.default_rng(3)
    x = rng.uniform(0.1, 5, (3, 7, 9)).astype(np.float32)
    w = (rng.uniform(0, 1, (3, 7, 9)) > 0.3) if weighted else None
    got = tops.geometric_mean(*_t(x, w), dim=dim, keepdim=dim is not None)
    _close(got, jops.geometric_mean(*_j(x, w), axis=dim, keepdims=dim is not None))


def test_angle_between():
    rng = np.random.default_rng(4)
    v1, v2 = rng.standard_normal((2, 40, 3)).astype(np.float32)
    v2[0] = v1[0]  # parallel: the atan2 form stays accurate
    _close(tops.angle_between(*_t(v1, v2)), jops.angle_between(*_j(v1, v2)))


def _band_equal(got, want, value, threshold):
    """Masks equal except within BAND (relative) of ``threshold``; returns
    the count of pixels inside the band."""
    got, want, value = got.numpy(), np.asarray(want), np.asarray(value, np.float64)
    band = np.abs(value - threshold) <= BAND * np.abs(threshold)
    np.testing.assert_array_equal(got[~band], want[~band])
    return int(band.sum())


@pytest.mark.parametrize("pooler,rtol", [("max", 0.2), ("min", 0.2), ("max", 0.05)])
def test_threshold_depth_change(pooler, rtol):
    rng = np.random.default_rng(5)
    depth = _depth(rng)
    mask = rng.uniform(0, 1, depth.shape) > 0.1
    got = tops.threshold_depth_change(*_t(depth, mask), pooler, rtol)
    want = jops.threshold_depth_change(*_j(depth, mask), pooler, rtol)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(np.asarray(want).any())


@pytest.mark.parametrize("kernel_size", [3, 5])
def test_depth_map_edge(kernel_size):
    rng = np.random.default_rng(6)
    depth = _depth(rng)
    depth[0, 3, 4] = np.inf
    mask = rng.uniform(0, 1, depth.shape) > 0.1
    for m in (None, mask):
        got = tops.depth_map_edge(*_t(depth), kernel_size=kernel_size, mask=None if m is None else _t(m)[0])
        want = jops.depth_map_edge(*_j(depth), kernel_size=kernel_size, mask=None if m is None else _j(m)[0])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert bool(np.asarray(want).any())


def test_normal_map_edge():
    rng = np.random.default_rng(7)
    depth = _depth(rng)
    normals, _ = jops.depth_map_to_normal_map(*_j(depth, _intrinsics(rng, 2)))
    normals = np.asarray(normals) + rng.normal(0, 0.05, np.shape(normals)).astype(np.float32)
    normals[1, 2, 2] = np.nan
    got = tops.normal_map_edge(*_t(normals))
    want = jops.normal_map_edge(*_j(normals))
    assert bool(np.asarray(want).any())
    # each pixel's least dot product with its neighbours, the tested quantity
    n = np.where(np.isfinite(normals).all(-1, keepdims=True), normals, 0).astype(np.float64)
    dots = np.min([(n * np.roll(n, (di, dj), axis=(-3, -2))).sum(-1) for di in (-1, 0, 1) for dj in (-1, 0, 1)
                   if (di, dj) != (0, 0)], axis=0)
    assert _band_equal(got, want, dots, math.cos(math.radians(15.0))) == 0


def test_normals_from_points_and_depth():
    rng = np.random.default_rng(8)
    depth = _depth(rng)
    k = _intrinsics(rng, 2)
    mask = rng.uniform(0, 1, depth.shape) > 0.05
    _close(tops.depth_map_to_normal_map(*_t(depth, k)), jops.depth_map_to_normal_map(*_j(depth, k)))
    points = np.array(jops.depth_map_to_point_map(*_j(depth, k)))
    points[0, 5, 5] = np.nan
    for m in (None, mask):
        got = tops.point_map_to_normal_map(*_t(points), mask=None if m is None else _t(m)[0])
        want = jops.point_map_to_normal_map(*_j(points), mask=None if m is None else _j(m)[0])
        _close(got, want)


@pytest.mark.parametrize("window,stride", [(3, 1), (5, 2), (2, 3)])
def test_sliding_window_2d(window, stride):
    x = np.random.default_rng(9).standard_normal((2, 11, 13)).astype(np.float32)
    got = tops.sliding_window_2d(*_t(x), window, stride)
    want = jops.sliding_window_2d(*_j(x), window, stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("filter", ["min", "max", "mean", "median"])
def test_dilate_with_mask(filter):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 12, 15)).astype(np.float32)
    mask = rng.uniform(0, 1, x.shape) > 0.6
    got = tops.dilate_with_mask(*_t(x, mask), filter=filter, iterations=3)
    want = jops.dilate_with_mask(*_j(x, mask), filter=filter, iterations=3)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_refine_depth_with_normal():
    rng = np.random.default_rng(11)
    depth = _depth(rng, b=1, h=20, w=26)[0]
    k = _intrinsics(rng, 1)[0]
    normal, _ = jops.depth_map_to_normal_map(*_j(depth, k))
    normal = np.asarray(normal) + rng.normal(0, 0.02, np.shape(normal)).astype(np.float32)
    got = tops.refine_depth_with_normal(*_t(depth, normal, k), iterations=10)
    want = jops.refine_depth_with_normal(*_j(depth, normal, k), iterations=10)
    _close(got, want)


@pytest.mark.parametrize("kernel_size,sigma", [(3, 1.0), (5, 2.0), (4, 0.7)])
def test_gaussian_blur_2d(kernel_size, sigma):
    x = np.random.default_rng(12).standard_normal((2, 10, 14)).astype(np.float32)
    _close(tops.gaussian_blur_2d(*_t(x), kernel_size, sigma), jops.gaussian_blur_2d(*_j(x), kernel_size, sigma))


@pytest.mark.parametrize("mode,antialias,scale_factor", [
    ("bilinear", False, None), ("bilinear", True, None), ("bicubic", False, None), ("bicubic", True, None),
    ("nearest", False, None), ("bicubic", False, 0.37), ("bilinear", False, 2.5)])
@pytest.mark.parametrize("sizes", [(37, 16), (16, 37), (518, 518 // 3)])
def test_resize_matrix_is_jaxs_bit_for_bit(mode, antialias, scale_factor, sizes):
    from moge_tpu.ops.resize import resize_matrix as jax_resize_matrix

    got = tops.resize_matrix(*sizes, mode, antialias, scale_factor)
    want = jax_resize_matrix(*sizes, mode, antialias, scale_factor)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("size,mode,antialias", [((20, 33), "bilinear", True), ((50, 41), "bilinear", False),
                                                 ((17, 23), "bicubic", True), ((50, 70), "nearest", False)])
def test_resize_image(size, mode, antialias):
    image = np.random.default_rng(13).uniform(0, 1, (2, 36, 48, 3)).astype(np.float32)
    got = tops.resize_image(*_t(image), size, mode, antialias)
    _close(got, jops.resize_image(*_j(image), size, mode, antialias))


def test_the_library_offers_jaxs_names():
    """``moge_tpu_torch.ops`` re-exports every function ``moge_tpu.ops``
    does, but for ``scaled_dot_product_attention`` (whose kernel falls back
    silently in JAX): ``flash_attention`` and ``attention_plain`` instead."""
    import moge_tpu.ops.__init__ as jinit

    names = {n for n in vars(jinit) if not n.startswith("_") and callable(getattr(jinit, n))
             and not isinstance(getattr(jinit, n), type(math))}
    assert sorted(names - set(vars(tops))) == ["scaled_dot_product_attention"]
    assert callable(tops.flash_attention) and callable(tops.attention_plain)
