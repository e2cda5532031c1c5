"""The port's panorama pipeline (moge_tpu_torch.panorama and
scripts.infer_panorama) against the JAX package's (moge_tpu.panorama, whose
resampling is cv2.remap) on the CPU, at small sizes: the camera rig, the
sparse equations, the torch resampling against the OpenCV the tests run
with, the split, both merges, the known-field recovery and the whole
pipeline on tiny MoGe-2 and MoGe-1 models with bridged weights."""

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from moge_tpu import panorama as jpano
from moge_tpu.utils.geometry_numpy import uv_map_numpy
from moge_tpu_torch import panorama as pano
from moge_tpu_torch.scripts.infer_panorama import infer_panorama
from torch_tiny_config import (TINY_CONFIG, make_points_perspective, smooth_distance, smooth_field_views,
                               state_dict_from_jax_params)

torch.set_num_threads(1)

RIG_TOL = 1e-6
SPLIT_F32_RTOL = 1e-5   # fp32 bilinear weights, summed in another order than cv2
SPLIT_U8_LEVELS = 1     # cv2 rounds the same bilinear value to the nearest level
LSMR_RTOL = 1e-4        # same system; fp32 inputs summed in another order move LSMR's stop (read: 1.6e-5)
CG_RTOL = 1e-4          # 300 fp32 CG iterations from inputs that differ in the last bit (read: 3.7e-5)
PIPE_DEPTH_RTOL = 1e-3  # median relative depth of the whole pipeline, port vs JAX
PIPE_MASK_AGREE = 0.99


def _cameras():
    extrinsics, intrinsics = pano.get_panorama_cameras()
    return extrinsics, intrinsics


def test_rig_matches_jax():
    ext_t, k_t = pano.get_panorama_cameras()
    ext_j, k_j = jpano.get_panorama_cameras()
    np.testing.assert_allclose(ext_t, ext_j, atol=RIG_TOL)
    np.testing.assert_allclose(np.stack(k_t), np.stack(k_j), atol=RIG_TOL)
    uv = np.random.default_rng(0).uniform(0.01, 0.99, (64, 2)).astype(np.float32)
    d_t, d_j = pano.spherical_uv_to_directions(uv), jpano.spherical_uv_to_directions(uv)
    np.testing.assert_allclose(d_t, d_j, atol=RIG_TOL)
    np.testing.assert_allclose(pano.directions_to_spherical_uv(d_t), jpano.directions_to_spherical_uv(d_j),
                               atol=RIG_TOL)
    np.testing.assert_allclose(pano.uv_to_pixel(uv, (30, 60)), jpano.uv_to_pixel(uv, (30, 60)), atol=RIG_TOL)
    for E, K in zip(ext_t, k_t):
        np.testing.assert_allclose(pano._unproject(uv, E, K), jpano._unproject(uv, E, K), atol=RIG_TOL)
        for a, b in zip(pano._project(d_t, E, K), jpano._project(d_j, E, K)):
            np.testing.assert_allclose(a, b, atol=RIG_TOL)


@pytest.mark.parametrize("wrap_x,wrap_y", [(True, False), (False, False), (True, True)])
def test_sparse_equations_match_jax(wrap_x, wrap_y):
    for ours, theirs in ((pano.grad_equation, jpano.grad_equation), (pano.poisson_equation, jpano.poisson_equation)):
        a, b = ours(7, 5, wrap_x, wrap_y), theirs(7, 5, wrap_x, wrap_y)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a != b).nnz == 0


def test_remap_matches_cv2():
    """Bilinear (fp32 and uint8) and nearest resampling with a replicated
    border against cv2.remap, at random coordinates inside and outside the
    image and at the half-integers where nearest must round half to even."""
    rng = np.random.default_rng(1)
    h, w = 17, 23
    image = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    mx = rng.uniform(-2, w + 1, (40, 50)).astype(np.float32)
    my = rng.uniform(-2, h + 1, (40, 50)).astype(np.float32)
    pixels = torch.from_numpy(np.stack([mx, my], -1))[None]
    got = pano.remap_bilinear(torch.from_numpy(image)[None], pixels)[0].numpy()
    want = cv2.remap(image, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REPLICATE)
    np.testing.assert_allclose(got, want, rtol=SPLIT_F32_RTOL, atol=SPLIT_F32_RTOL)

    image8 = (image * 255).astype(np.uint8)
    got8 = pano.remap_bilinear(torch.from_numpy(image8)[None], pixels)[0].numpy()
    want8 = cv2.remap(image8, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REPLICATE)
    assert got8.dtype == np.uint8
    assert np.abs(got8.astype(int) - want8.astype(int)).max() <= SPLIT_U8_LEVELS

    hx = np.tile((np.arange(-2, w + 1) + 0.5).astype(np.float32), (h + 3, 1))
    hy = np.tile((np.arange(-2, h + 1) + 0.5).astype(np.float32)[:, None], (1, w + 3))
    for x, y in ((mx, my), (hx, hy), (hx, np.round(hy - 0.5))):
        got = pano.remap_nearest(torch.from_numpy(image8)[None], torch.from_numpy(np.stack([x, y], -1))[None])[0]
        np.testing.assert_array_equal(got.numpy(),
                                      cv2.remap(image8, x, y, cv2.INTER_NEAREST, borderMode=cv2.BORDER_REPLICATE))


@pytest.mark.parametrize("src,dst", [((60, 120), (120, 240)), ((75, 150), (150, 300)), ((32, 61), (64, 128))])
def test_resizes_match_cv2(src, dst):
    """The merge's multigrid upsample and the pipeline's final resizes
    (cv2.resize INTER_LINEAR / INTER_NEAREST in the JAX package) by
    F.interpolate."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0.5, 2, src).astype(np.float32)
    got = F.interpolate(torch.from_numpy(x)[None, None], size=dst, mode="bilinear", align_corners=False)[0, 0]
    want = cv2.resize(x, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(got.numpy(), want, rtol=SPLIT_F32_RTOL)
    m = rng.uniform(0, 1, src) > 0.5
    got = F.interpolate(torch.from_numpy(m)[None, None].to(torch.uint8), size=dst, mode="nearest")[0, 0] > 0
    np.testing.assert_array_equal(got.numpy(), cv2.resize(m.astype(np.uint8), dst[::-1],
                                                          interpolation=cv2.INTER_NEAREST) > 0)


@pytest.mark.parametrize("resolution", [24, 40, 56])
def test_split_matches_jax(resolution):
    extrinsics, intrinsics = _cameras()
    rng = np.random.default_rng(resolution)
    image8 = rng.integers(0, 256, (40, 80, 3)).astype(np.uint8)
    got = pano.split_panorama_image(torch.from_numpy(image8), extrinsics, intrinsics, resolution)
    want = np.stack(jpano.split_panorama_image(image8, extrinsics, intrinsics, resolution))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (12, resolution, resolution, 3)
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= SPLIT_U8_LEVELS

    image = rng.uniform(0, 1, (40, 80, 3)).astype(np.float32)
    got = pano.split_panorama_image(torch.from_numpy(image), extrinsics, intrinsics, resolution).numpy()
    want = np.stack(jpano.split_panorama_image(image, extrinsics, intrinsics, resolution))
    np.testing.assert_allclose(got, want, rtol=SPLIT_F32_RTOL, atol=SPLIT_F32_RTOL)


@pytest.mark.parametrize("size", [(128, 64), (300, 150)], ids=["one_level", "two_levels"])
@pytest.mark.parametrize("solver", ["lsmr", "cg"])
def test_merge_matches_jax(solver, size):
    """Both solvers against the JAX package's, with blocks masked in every
    third view (masked rows and the wrap column's doubled y weight); at
    300x150 through one multigrid level."""
    extrinsics, intrinsics = _cameras()
    distance_maps, masks = smooth_field_views(knock_out=True)
    width, height = size
    want, want_mask = jpano.merge_panorama_depth(width, height, list(distance_maps), list(masks), list(extrinsics),
                                                 intrinsics, solver=solver)
    got, got_mask = pano.merge_panorama_depth(width, height, torch.from_numpy(distance_maps),
                                              torch.from_numpy(masks), extrinsics, intrinsics, solver=solver)
    assert got.dtype == torch.float32 and tuple(got.shape) == (height, width)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    rel = np.abs(got.numpy() - want) / want
    assert rel.max() <= (LSMR_RTOL if solver == "lsmr" else CG_RTOL), float(rel.max())
    if solver == "cg":
        assert pano.CG_ITERATIONS[(width, height)] == pano.CG_MAXITER  # fp32 never reaches 1e-7 here


def test_merge_cg_matches_lsmr():
    """The port's CG against its LSMR, with the bounds of
    tests/test_panorama.py::test_merge_cg_matches_lsmr."""
    extrinsics, intrinsics = _cameras()
    d, m = (torch.from_numpy(a) for a in smooth_field_views(knock_out=True))
    lsmr, mask_lsmr = pano.merge_panorama_depth(128, 64, d, m, extrinsics, intrinsics, solver="lsmr")
    cg, mask_cg = pano.merge_panorama_depth(128, 64, d, m, extrinsics, intrinsics, solver="cg")
    np.testing.assert_array_equal(mask_cg.numpy(), mask_lsmr.numpy())
    rel = ((cg - lsmr).abs() / lsmr).numpy()
    assert np.median(rel) < 1e-3 and rel.max() < 2e-2, (float(np.median(rel)), float(rel.max()))


@pytest.mark.parametrize("solver", ["lsmr", "cg"])
def test_merge_recovers_smooth_field(solver):
    """Known-field recovery with the JAX test's bounds: after the
    median-scale gauge, median relative error < 0.02 and mean < 0.05."""
    extrinsics, intrinsics = _cameras()
    distance_maps, masks = smooth_field_views()
    width, height = 128, 64
    merged, merged_mask = pano.merge_panorama_depth(width, height, torch.from_numpy(distance_maps),
                                                    torch.from_numpy(masks), extrinsics, intrinsics, solver=solver)
    assert bool(merged_mask.all())
    gt = smooth_distance(pano.spherical_uv_to_directions(uv_map_numpy(height, width)))
    merged = merged.numpy()
    rel = np.abs(merged * np.median(gt / merged) - gt) / gt
    assert np.median(rel) < 0.02 and rel.mean() < 0.05


def test_merge_rejects_an_unknown_solver():
    distance_maps, masks = smooth_field_views(res=8)
    with pytest.raises(ValueError, match="solver"):
        pano.merge_panorama_depth(16, 8, torch.from_numpy(distance_maps), torch.from_numpy(masks), *_cameras(),
                                  solver="gmres")


PANO_HW = (64, 128)
SPLIT_RES = 56
NUM_TOKENS_RANGE = [16, 36]


def _tiny_models(version):
    """(JAX model, port model) with the same weights: MoGe-2 on
    ``TINY_CONFIG`` with the points head set to a known perspective
    (``make_points_perspective``), MoGe-1 on the tiny config of
    test_torch_cli, both with few tokens."""
    from moge_tpu.models.convert import convert_moge1, convert_moge2

    if version == "v2":
        from moge_tpu.models.v2 import MoGeModel as JaxModel
        from moge_tpu_torch.models.v2 import MoGeModel

        cfg = dict(TINY_CONFIG, num_tokens_range=NUM_TOKENS_RANGE)
        jm = JaxModel(cfg, None, dtype=jnp.float32).init_random(seed=0, image_hw=(56, 56))
        tm = MoGeModel(cfg, "cpu", torch.float32)
        tm.module.load_state_dict(state_dict_from_jax_params(cfg, jax.tree.map(np.asarray, jm.params)), strict=True)
        make_points_perspective(tm.module)
        convert = convert_moge2
    else:
        from moge_tpu.models.v1 import MoGeModel as JaxModel
        from moge_tpu_torch.models.v1 import MoGeModel
        from torch_tiny_config import v1_state_dict_from_jax_params

        cfg = {"encoder": "dinov2_vitt14", "intermediate_layers": 4, "dim_proj": 32, "dim_upsample": [32, 16, 16],
               "dim_times_res_block_hidden": 2, "num_res_blocks": 1, "remap_output": "exp",
               "res_block_norm": "group_norm", "last_res_blocks": 1, "last_conv_channels": 32,
               "last_conv_size": 1, "num_tokens_range": NUM_TOKENS_RANGE}
        jm = JaxModel(cfg, None, dtype=jnp.float32).init_random(seed=0, image_hw=(56, 56))
        tm = MoGeModel(cfg, "cpu", torch.float32)
        tm.module.load_state_dict(v1_state_dict_from_jax_params(cfg, jax.tree.map(np.asarray, jm.params)),
                                  strict=True)
        convert = convert_moge1
    sd = {k: v.numpy() for k, v in tm.module.state_dict().items()}
    _, params = convert({"model_config": cfg, "model": sd})
    return JaxModel(cfg, params, dtype=jnp.float32), tm


def _jax_pipeline(model, image):
    """The JAX command's steps (moge_tpu/scripts/infer_panorama.py:70-99) at
    ``SPLIT_RES``, merged by LSMR at the image's size."""
    extrinsics, intrinsics = jpano.get_panorama_cameras()
    views = jpano.split_panorama_image(image, extrinsics, intrinsics, SPLIT_RES)
    out = model.infer(jnp.asarray(np.stack(views).astype(np.float32) / 255.0), fov_x=90.0, apply_mask=False,
                      resolution_level=9)
    distances = list(np.linalg.norm(np.asarray(out["points"]), axis=-1))
    masks = list(np.asarray(out["mask"]))
    height, width = image.shape[:2]
    depth, mask = jpano.merge_panorama_depth(width, height, distances, masks, list(extrinsics), intrinsics)
    return depth, mask, np.stack(distances)


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_infer_panorama_matches_jax(version):
    jm, tm = _tiny_models(version)
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:PANO_HW[0], 0:PANO_HW[1]]
    image = np.stack([128 + 100 * np.sin(xx / 9.0), 128 + 100 * np.cos(yy / 7.0),
                      rng.integers(0, 256, PANO_HW)], -1).astype(np.uint8)
    want_depth, want_mask, want_dist = _jax_pipeline(jm, image)
    got = infer_panorama(tm, image, resolution_level=9, merge_solver="lsmr", split_resolution=SPLIT_RES)
    assert tuple(got["views"].shape) == (12, SPLIT_RES, SPLIT_RES, 3) and got["views"].dtype == torch.uint8
    assert tuple(got["depth"].shape) == PANO_HW and tuple(got["points"].shape) == (*PANO_HW, 3)
    assert np.median(np.abs(got["distances"].numpy() - want_dist) / want_dist) <= PIPE_DEPTH_RTOL
    mask = got["mask"].numpy()
    assert (mask == want_mask).mean() >= PIPE_MASK_AGREE
    both = mask & want_mask
    assert both.any()
    depth = got["depth"].numpy()
    assert np.median(np.abs(depth[both] - want_depth[both]) / want_depth[both]) <= PIPE_DEPTH_RTOL
    np.testing.assert_allclose(np.linalg.norm(got["points"].numpy(), axis=-1), depth, rtol=1e-5)


def test_infer_panorama_batches_the_views():
    """``batch_size`` splits the 12 views into several ``infer`` calls (the
    field of view taken from each batch's first view); the result is the
    one-batch result, up to fp32 summation order."""
    from moge_tpu_torch.models.v2 import MoGeModel

    model = MoGeModel(dict(TINY_CONFIG, num_tokens_range=NUM_TOKENS_RANGE), "cpu", torch.float32).init_random(seed=1)
    make_points_perspective(model.module)
    image = np.random.default_rng(6).integers(0, 256, (*PANO_HW, 3)).astype(np.uint8)
    whole = infer_panorama(model, image, split_resolution=SPLIT_RES, merge_solver="cg")
    parts = infer_panorama(model, image, split_resolution=SPLIT_RES, merge_solver="cg", batch_size=5)
    torch.testing.assert_close(parts["distances"], whole["distances"], rtol=1e-5, atol=0)
    assert torch.equal(parts["view_masks"], whole["view_masks"]) and torch.equal(parts["mask"], whole["mask"])
    torch.testing.assert_close(parts["depth"], whole["depth"], rtol=1e-4, atol=0)
