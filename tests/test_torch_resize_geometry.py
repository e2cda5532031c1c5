"""The port's resampling, geometry and camera solvers (moge_tpu_torch.ops)
against the JAX package's ``resize_2d``, geometry functions and
``recover_focal_shift``, in fp32 on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from moge_tpu.ops import geometry as jax_geometry
from moge_tpu.ops.resize import resize_2d as jax_resize
from moge_tpu.ops.solvers import recover_focal_shift as jax_recover
from moge_tpu_torch.ops import geometry
from moge_tpu_torch.ops.resize import resize_2d
from moge_tpu_torch.ops.solvers import recover_focal_shift

torch.set_num_threads(1)

RESIZE_TOL = 1e-5   # F.interpolate vs the JAX package's torch-exact matrices, fp32
SOLVE_RTOL = 1e-3   # 30-step LM, analytic vs jax.jvp derivative: rounding-level path differences


@pytest.mark.parametrize("src,dst,mode,antialias", [
    ((100, 150), (42, 56), "bilinear", True),     # input resize to the token grid
    ((37, 74), (518, 1036), "bilinear", True),    # antialias is a no-op when upsampling
    ((16, 24), (61, 47), "bilinear", False),      # output epilogue
    ((100, 130), (64, 64), "nearest", False),     # solver downsample (legacy nearest)
    ((518, 700), (64, 64), "nearest", False),
])
def test_resize_matches(src, dst, mode, antialias):
    x = np.random.default_rng(sum(src)).uniform(0, 1, (2, *src, 3)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), dst, mode=mode, antialias=antialias))
    got = resize_2d(torch.from_numpy(x), dst, mode=mode, antialias=antialias).numpy()
    np.testing.assert_allclose(got, want, rtol=RESIZE_TOL, atol=RESIZE_TOL)


@pytest.mark.parametrize("h0,w0", [(4, 6), (37, 37), (60, 60), (42, 85)])
def test_bicubic_scale_factor_matches(h0, w0):
    """The DINOv2 pos-embed interpolation: bicubic from 37x37 with scale_factor (h0 + 0.1) / 37."""
    pe = np.random.default_rng(h0 * w0).standard_normal((1, 37, 37, 16)).astype(np.float32)
    sf = ((h0 + 0.1) / 37, (w0 + 0.1) / 37)
    want = np.asarray(jax_resize(jnp.asarray(pe), (h0, w0), mode="bicubic", scale_factor=sf))
    got = resize_2d(torch.from_numpy(pe), (h0, w0), mode="bicubic", scale_factor=sf).numpy()
    np.testing.assert_allclose(got, want, rtol=RESIZE_TOL, atol=RESIZE_TOL)


def test_resize_without_channels():
    m = np.random.default_rng(1).uniform(0, 1, (3, 50, 70)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(m), (64, 64), mode="nearest", channel_last=False))
    got = resize_2d(torch.from_numpy(m), (64, 64), mode="nearest", channel_last=False).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w,h,aspect", [(7, 5, None), (64, 64, None), (10, 20, 1.5)])
def test_view_plane_uv_matches(w, h, aspect):
    want = np.asarray(jax_geometry.normalized_view_plane_uv(w, h, aspect))
    got = geometry.normalized_view_plane_uv(w, h, aspect).numpy()
    np.testing.assert_array_equal(got, want)


def test_intrinsics_and_unprojection_match():
    rng = np.random.default_rng(2)
    fx, fy = rng.uniform(0.5, 2, 3).astype(np.float32), rng.uniform(0.5, 2, 3).astype(np.float32)
    want_k = np.asarray(jax_geometry.intrinsics_from_focal_center(jnp.asarray(fx), jnp.asarray(fy), 0.5, 0.5))
    got_k = geometry.intrinsics_from_focal_center(torch.from_numpy(fx), torch.from_numpy(fy), 0.5, 0.5).numpy()
    np.testing.assert_array_equal(got_k, want_k)
    depth = rng.uniform(1, 5, (3, 9, 11)).astype(np.float32)
    want = np.asarray(jax_geometry.depth_map_to_point_map(jnp.asarray(depth), jnp.asarray(want_k)))
    got = geometry.depth_map_to_point_map(torch.from_numpy(depth), torch.from_numpy(got_k)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _affine_points(b, h, w, seed):
    """Point maps of a pinhole camera (focal ~1.2, half-diagonal units) with
    the z-shift the solver has to undo, plus noise and a random mask."""
    rng = np.random.default_rng(seed)
    uv = np.asarray(jax_geometry.normalized_view_plane_uv(w, h))
    depth = rng.uniform(2, 6, (b, h, w)).astype(np.float32)
    focal = rng.uniform(0.8, 1.6, (b, 1, 1)).astype(np.float32)
    xy = uv[None] * depth[..., None] / focal[..., None]
    pts = np.concatenate([xy, depth[..., None] - rng.uniform(0.5, 1.5, (b, 1, 1, 1))], axis=-1)
    pts += rng.standard_normal(pts.shape).astype(np.float32) * 0.01
    mask = rng.uniform(0, 1, (b, h, w)) > 0.3
    return pts.astype(np.float32), mask


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("known_focal", [False, True])
def test_recover_focal_shift_matches(use_mask, known_focal):
    pts, mask = _affine_points(3, 90, 120, seed=int(use_mask) + 2 * int(known_focal))
    focal = np.asarray([0.9, 1.2, 1.5], np.float32) if known_focal else None
    m = mask if use_mask else None
    fj, sj = jax_recover(jnp.asarray(pts), None if m is None else jnp.asarray(m),
                         None if focal is None else jnp.asarray(focal))
    ft, st = recover_focal_shift(torch.from_numpy(pts), None if m is None else torch.from_numpy(m),
                                 None if focal is None else torch.from_numpy(focal))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=SOLVE_RTOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=SOLVE_RTOL, atol=SOLVE_RTOL)


def test_recover_focal_shift_degenerate():
    """Fewer than 2 valid pixels -> (1, 0), as the JAX package and the reference."""
    pts, _ = _affine_points(2, 128, 128, seed=9)
    mask = np.zeros((2, 128, 128), bool)
    mask[1, 0, 0] = True  # one valid pixel after the 64x64 downsample: still degenerate
    fj, sj = jax_recover(jnp.asarray(pts), jnp.asarray(mask))
    ft, st = recover_focal_shift(torch.from_numpy(pts), torch.from_numpy(mask))
    np.testing.assert_array_equal(ft.numpy(), [1.0, 1.0])
    np.testing.assert_array_equal(st.numpy(), [0.0, 0.0])
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
