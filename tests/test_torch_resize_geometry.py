"""The port's resampling, geometry and camera solvers (moge_tpu_torch.ops)
against the JAX package's ``resize_2d``, geometry functions and
``recover_focal_shift``, in fp32 on the CPU; and the op
``moge::camera_solve`` (kernel K5 on the card) on the CPU: the plain
solvers on K5's samples exactly, its fake implementation, what it refuses,
its routes and its sample table."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from moge_tpu.ops import geometry as jax_geometry
from moge_tpu.ops.resize import resize_2d as jax_resize
from moge_tpu.ops.solvers import recover_focal_shift as jax_recover
from moge_tpu_torch.ops import _build, geometry, solvers
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


# ---- the camera solve as the op moge::camera_solve (kernel K5 on the card) ----
# On the CPU the op runs the plain version; these tests hold it, and the
# sample table and gather K5 uses, to the plain solvers exactly.


def _solve_from_table(pts, mask, focal, size=(64, 64)):
    """The plain solvers on the samples gathered as K5 gathers them:
    ``sample_table``'s source pixels and uv, a masked sample taken as (0, 0,
    1) of weight 0, (1, 0) where fewer than 2 samples are valid."""
    b, h, w, _ = pts.shape
    uv, pixel = solvers.sample_table(h, w, *size)
    p = pts.float().reshape(b, h * w, 3)[:, pixel.long()]
    keep = torch.ones(b, len(pixel), dtype=torch.bool) if mask is None else mask.reshape(b, h * w)[:, pixel.long()]
    p = torch.where(keep[..., None], p, torch.tensor([0.0, 0.0, 1.0]))
    weight = keep.float()
    uv = uv.expand(b, -1, 2)
    if focal is None:
        shift, f = solvers.solve_optimal_focal_shift(uv, p, weight)
    else:
        f, shift = focal, solvers.solve_optimal_shift(uv, p, focal, weight)
    degenerate = weight.sum(-1) < 2
    return torch.where(degenerate, 1.0, f), torch.where(degenerate, 0.0, shift)


def _solve_case(batch, use_mask, known_focal, seed, dtype=torch.float32):
    pts, mask = _affine_points(batch, 90, 120, seed=seed)
    if use_mask and batch > 1:
        mask[batch // 2] = False
        mask[batch // 2, 0, 0] = True  # one valid sample: degenerate, beside sound items
    focal = torch.from_numpy(np.random.default_rng(seed).uniform(0.8, 1.6, batch).astype(np.float32))
    return (torch.from_numpy(pts).to(dtype), torch.from_numpy(mask) if use_mask else None,
            focal if known_focal else None)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("known_focal", [False, True])
def test_camera_solve_op_on_cpu_is_the_plain_path(batch, use_mask, known_focal):
    pts, mask, focal = _solve_case(batch, use_mask, known_focal, seed=batch + 2 * use_mask + 4 * known_focal)
    got = torch.ops.moge.camera_solve(pts, mask, focal, 64, 64, 30)
    want = _solve_from_table(pts, mask, focal)
    for g, w in zip(got, want):
        assert g.shape == (batch,) and g.dtype == torch.float32
        assert torch.equal(g, w)
    if use_mask and batch > 1:
        assert got[0][batch // 2].item() == 1.0 and got[1][batch // 2].item() == 0.0
    flat = solvers.recover_focal_shift(pts, mask, focal)
    assert all(torch.equal(a, b) for a, b in zip(flat, got))


def test_recover_focal_shift_takes_bf16_points_as_their_fp32_values():
    pts, mask, _ = _solve_case(8, True, False, seed=11, dtype=torch.bfloat16)
    got = recover_focal_shift(pts, mask)
    want = torch.ops.moge.camera_solve(pts.float(), mask, None, 64, 64, 30)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("batch_shape", [(), (3,), (2, 3)])
@pytest.mark.parametrize("known_focal", [False, True])
def test_recover_focal_shift_keeps_the_leading_shape(batch_shape, known_focal):
    """(..., H, W, 3) in, (focal, shift) of shape (...) out, each item as
    solved alone; a known focal may be a scalar, broadcast over the items."""
    n = int(np.prod(batch_shape))
    pts, mask, _ = _solve_case(n, True, False, seed=12)
    focal = 1.25 if known_focal else None
    got = recover_focal_shift(pts.reshape(*batch_shape, *pts.shape[1:]),
                              mask.reshape(*batch_shape, *mask.shape[1:]), focal)
    assert [(t.shape, t.dtype) for t in got] == [(batch_shape, torch.float32)] * 2
    f = None if focal is None else torch.full((n,), focal)
    want = torch.ops.moge.camera_solve(pts, mask, f, 64, 64, 30)
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(-1), w)


@pytest.mark.parametrize("known_focal", [False, True])
def test_camera_solve_fake_gives_two_fp32_vectors(known_focal):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        pts = torch.empty(5, 48, 64, 3)
        mask = torch.empty(5, 48, 64, dtype=torch.bool)
        focal = torch.empty(5) if known_focal else None
        out = torch.ops.moge.camera_solve(pts, mask, focal, 64, 64, 30)
    assert [(o.shape, o.dtype) for o in out] == [((5,), torch.float32)] * 2


@pytest.mark.parametrize("fault", ["non-contiguous points", "mask shape", "mask device", "focal device",
                                   "bf16 points", "focal dtype"])
def test_camera_solve_rejects_what_the_kernel_does_not_take(fault):
    pts, mask, focal = _solve_case(2, True, True, seed=5)
    if fault == "non-contiguous points":
        pts = pts.transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "mask shape":
        mask = mask[:, :, 1:]
    elif fault == "mask device":
        mask = mask.to("meta")
    elif fault == "focal device":
        focal = focal.to("meta")
    elif fault == "bf16 points":
        pts = pts.bfloat16()
    else:
        focal = focal.double()
    with pytest.raises(TypeError if fault == "bf16 points" else ValueError):
        torch.ops.moge.camera_solve(pts, mask, focal, 64, 64, 30)


@pytest.mark.parametrize("known_focal", [False, True])
def test_camera_solve_opcheck(known_focal):
    pts, mask, focal = _solve_case(2, True, known_focal, seed=6)
    torch.library.opcheck(torch.ops.moge.camera_solve.default, (pts, mask, focal, 16, 16, 5))


def test_recover_focal_shift_routes():
    """CPU tensors run the plain version (no launch); a traced program holds
    one ``moge::camera_solve`` node, which gives the same numbers."""

    class Solve(torch.nn.Module):
        def forward(self, points, mask):
            return solvers.recover_focal_shift(points, mask)

    pts, mask, _ = _solve_case(8, True, False, seed=7)
    before = _build.read_launches()
    want = Solve()(pts, mask)
    assert _build.read_launches() == before
    program = torch.export.export(Solve(), (pts, mask), strict=False)
    nodes = [str(n.target) for n in program.graph.nodes if n.op == "call_function" and "moge" in str(n.target)]
    assert nodes == ["moge.camera_solve.default"]
    assert all(torch.equal(a, b) for a, b in zip(program.module()(pts, mask), want))


@pytest.mark.parametrize("size", [(64, 64), (48, 40)])
@pytest.mark.parametrize("h,w", [(480, 640), (518, 518), (37, 53), (100, 130), (700, 518)])
def test_sample_table_is_the_plain_downsample(h, w, size):
    """K5's samples (source pixel, uv) are what the plain version's
    legacy-nearest downsample takes; at 64x64 also the JAX package's
    ``resize_matrix`` indices."""
    from moge_tpu_torch.ops.resize import resize_matrix

    uv, pixel = solvers.sample_table(h, w, *size)
    assert uv.shape == (size[0] * size[1], 2) and uv.dtype == torch.float32 and pixel.dtype == torch.int32
    grid = torch.from_numpy(np.random.default_rng(h * w).standard_normal((h, w, 3)).astype(np.float32))
    want = resize_2d(grid, size, mode="nearest").reshape(-1, 3)
    assert torch.equal(grid.reshape(-1, 3)[pixel.long()], want)
    want_uv = resize_2d(geometry.normalized_view_plane_uv(w, h), size, mode="nearest").reshape(-1, 2)
    assert torch.equal(uv, want_uv)
    if size == (64, 64):
        rows = resize_matrix(h, size[0], "nearest").argmax(-1)
        cols = resize_matrix(w, size[1], "nearest").argmax(-1)
        np.testing.assert_array_equal(pixel.numpy(), (rows[:, None] * w + cols[None, :]).reshape(-1))
