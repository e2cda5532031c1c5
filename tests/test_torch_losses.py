"""The port's training losses (moge_tpu_torch.train.losses) and the geometry
helpers they use against the JAX package, values and gradients, on seeded
numpy inputs in fp32. The random draws (anchor-weight test offsets and the
per-instance anchor choice) are the JAX package's own, made from its keys
and fed to the port through ``losses.draw``."""

import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moge_tpu.ops import geometry as jgeo
from moge_tpu.train import losses as JL
from moge_tpu.train.step import compute_losses as jax_compute_losses
from moge_tpu_torch.ops import geometry
from moge_tpu_torch.train import losses
from moge_tpu_torch.train.step import compute_losses

torch.set_num_threads(1)

TOL = 1e-5       # fp32 on both sides; reductions in another order
GRAD_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _surface(b, h, w, seed):
    """Smooth depth maps (so that local patches hold enough 3D neighbours),
    intrinsics, and GT points with ~10% invalid pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    depth = np.stack([2 + 0.5 * np.sin(3 * xx + i) + 0.3 * yy for i in range(b)]).astype(np.float32)
    depth += 0.01 * rng.standard_normal(depth.shape).astype(np.float32)
    intr = np.broadcast_to(np.asarray([[1.0, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (b, 3, 3)).copy()
    fin = rng.uniform(size=(b, h, w)) > 0.1
    gt = np.asarray(jgeo.depth_map_to_point_map(jnp.asarray(depth), jnp.asarray(intr)))
    gt = np.where(fin[..., None], gt, np.inf).astype(np.float32)
    pred = (1.3 * np.where(fin[..., None], gt, 2.0) + 0.05 * rng.standard_normal(gt.shape)).astype(np.float32)
    return depth, intr, fin, gt, pred


def _jax_local_draws(key, gt_points, focal, level, num_patches):
    """The draws ``moge_tpu.train.losses.local_loss_prepare`` makes from
    ``key``, in the order the port asks for them: test offsets i and j, then
    the anchors (B, num_patches)."""
    mask = jnp.isfinite(gt_points).all(-1)
    gt = jnp.where(mask[..., None], gt_points, 1.0)
    b, h, w = mask.shape
    r2 = math.ceil(0.5 / level * (h ** 2 + w ** 2) ** 0.5)
    k_w, k_sel = jax.random.split(key)
    k1, k2 = jax.random.split(k_w)
    shape = (64,) if os.environ.get("MOGE_ANCHOR_WEIGHT_IMPL", "shift") == "shift" else (h, w, 64)
    di, dj = (jax.random.randint(k, shape, -r2, r2 + 1) for k in (k1, k2))
    weights = JL.compute_anchor_sampling_weight(k_w, gt, mask, r2, 0.5 / level / focal[:, None, None] * gt[..., 2])
    p = (weights * mask).reshape(b, h * w)
    p_sum = p.sum(-1, keepdims=True)
    p = jnp.where(p_sum > 0, p / jnp.maximum(p_sum, 1e-12), 1.0 / (h * w))
    rem = jax.vmap(lambda k, pb: jax.random.choice(k, h * w, (num_patches,), replace=True, p=pb))(
        jax.random.split(k_sel, b), p)
    return [np.asarray(di), np.asarray(dj), np.asarray(rem)]


def _inject(monkeypatch, draws):
    queue = list(draws)

    def fake_draw(gen, what, arg, size):
        value = queue.pop(0)
        want = tuple(size) if what == "offsets" else (arg.shape[0], size)
        assert value.shape == want, (what, value.shape, want)
        return torch.from_numpy(value.astype(np.int64))

    monkeypatch.setattr(losses, "draw", fake_draw)
    return queue


@pytest.fixture(params=["shift", "gather"])
def anchor_form(request, monkeypatch):
    monkeypatch.setenv("MOGE_ANCHOR_WEIGHT_IMPL", request.param)
    return request.param


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(1, 2, (3, 7, 9)).astype(np.float32)
    m = rng.uniform(size=x.shape) > 0.3
    for dim, axis in ((None, None), ((-2, -1), (-2, -1))):
        np.testing.assert_allclose(geometry.weighted_mean(_t(x), _t(m), dim).numpy(),
                                   np.asarray(jgeo.weighted_mean(jnp.asarray(x), jnp.asarray(m), axis)), rtol=TOL)
        np.testing.assert_allclose(geometry.harmonic_mean(_t(x), _t(m), dim).numpy(),
                                   np.asarray(jgeo.harmonic_mean(jnp.asarray(x), jnp.asarray(m), axis)), rtol=TOL)
    v1, v2 = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(geometry.angle_diff_vec3(_t(v1), _t(v2)).numpy(),
                               np.asarray(jgeo.angle_diff_vec3(jnp.asarray(v1), jnp.asarray(v2))), atol=1e-6)


@pytest.mark.parametrize("hw,size", [((50, 37), (12, 12)), ((17, 17), (6, 6)), ((10, 20), (24, 24))])
def test_masked_nearest_resize_matches_jax(hw, size):
    rng = np.random.default_rng(sum(hw))
    pts = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    d = rng.standard_normal((2, *hw)).astype(np.float32)
    mask = rng.uniform(size=(2, *hw)) > 0.6
    want = jgeo.masked_nearest_resize(jnp.asarray(pts), jnp.asarray(d), mask=jnp.asarray(mask), size=size,
                                      return_index=True)
    got = geometry.masked_nearest_resize(_t(pts), _t(d), mask=_t(mask), size=size, return_index=True)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got[3], want[3]):
        np.testing.assert_array_equal(np.broadcast_to(a.numpy(), np.asarray(b).shape), np.asarray(b))


def _check(got, want, leaf, jgrad, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)
    (g,) = torch.autograd.grad(got.sum(), leaf)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), rtol=GRAD_TOL, atol=GRAD_TOL * max(np.abs(jgrad).max(), 1))


def test_global_loss_matches_jax():
    _, _, _, gt, pred = _surface(2, 40, 48, 1)
    fn = lambda p: JL.affine_invariant_global_loss(p, jnp.asarray(gt), align_resolution=12)  # noqa: E731
    loss_j, misc_j, scale_j = fn(jnp.asarray(pred))
    leaf = _t(pred).requires_grad_()
    loss_t, misc_t, scale_t = losses.affine_invariant_global_loss(leaf, _t(gt), align_resolution=12)
    np.testing.assert_allclose(scale_t.numpy(), np.asarray(scale_j), rtol=TOL)
    for k in misc_j:
        np.testing.assert_allclose(misc_t[k].numpy(), np.asarray(misc_j[k]), rtol=TOL, atol=TOL)
    _check(loss_t, loss_j, leaf, jax.grad(lambda p: fn(p)[0].sum())(jnp.asarray(pred)))


def test_anchor_sampling_weight_matches_jax(monkeypatch, anchor_form):
    _, _, fin, gt, _ = _surface(2, 30, 26, 2)
    gt1 = np.where(fin[..., None], gt, 1.0).astype(np.float32)
    r3 = (0.1 * gt1[..., 2]).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = JL.compute_anchor_sampling_weight(key, jnp.asarray(gt1), jnp.asarray(fin), 5, jnp.asarray(r3))
    k1, k2 = jax.random.split(key)
    shape = (64,) if anchor_form == "shift" else (30, 26, 64)
    _inject(monkeypatch, [np.asarray(jax.random.randint(k, shape, -5, 6)) for k in (k1, k2)])
    got = losses.compute_anchor_sampling_weight(None, _t(gt1), _t(fin), 5, _t(r3), form=anchor_form)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=1e-8)


@pytest.mark.parametrize("global_scale", [False, True])
def test_local_loss_matches_jax(monkeypatch, anchor_form, global_scale):
    _, intr, _, gt, pred = _surface(2, 40, 48, 4)
    focal = (1.0 / np.sqrt(1.0 / intr[:, 0, 0] ** 2 + 1.0 / intr[:, 1, 1] ** 2)).astype(np.float32)
    gscale = np.asarray([0.75, 0.8], np.float32) if global_scale else None
    key = jax.random.PRNGKey(5)
    kw = dict(level=4, align_resolution=6, num_patches=8)
    fn = lambda p: JL.affine_invariant_local_loss(  # noqa: E731
        key, p, jnp.asarray(gt), jnp.asarray(focal), None if gscale is None else jnp.asarray(gscale), **kw)
    loss_j, misc_j = fn(jnp.asarray(pred))
    _inject(monkeypatch, _jax_local_draws(key, jnp.asarray(gt), jnp.asarray(focal), 4, 8))
    leaf = _t(pred).requires_grad_()
    loss_t, misc_t = losses.affine_invariant_local_loss(None, leaf, _t(gt), _t(focal),
                                                        None if gscale is None else _t(gscale),
                                                        anchor_weight_form=anchor_form, **kw)
    assert float(loss_j.sum()) > 0
    for k in misc_j:
        np.testing.assert_allclose(misc_t[k].detach().numpy(), np.asarray(misc_j[k]), rtol=TOL, atol=TOL)
    _check(loss_t, loss_j, leaf, jax.grad(lambda p: fn(p)[0].sum())(jnp.asarray(pred)))


def test_local_loss_reads_the_anchor_weight_form_from_the_environment(monkeypatch, anchor_form):
    """With no form passed, ``MOGE_ANCHOR_WEIGHT_IMPL`` selects it as in the
    JAX package (``gather`` the gather form, anything else the shift form):
    the two local losses agree under the variable alone."""
    _, intr, _, gt, pred = _surface(2, 40, 48, 7)
    focal = (1.0 / np.sqrt(1.0 / intr[:, 0, 0] ** 2 + 1.0 / intr[:, 1, 1] ** 2)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    kw = dict(level=4, align_resolution=6, num_patches=8)
    loss_j, misc_j = JL.affine_invariant_local_loss(key, jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(focal),
                                                    None, **kw)
    _inject(monkeypatch, _jax_local_draws(key, jnp.asarray(gt), jnp.asarray(focal), 4, 8))
    loss_t, misc_t = losses.affine_invariant_local_loss(None, _t(pred), _t(gt), _t(focal), None, **kw)
    assert float(loss_j.sum()) > 0
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=TOL, atol=TOL)
    for k in misc_j:
        np.testing.assert_allclose(misc_t[k].numpy(), np.asarray(misc_j[k]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["normal_loss", "edge_loss"])
def test_direction_losses_match_jax(name):
    _, _, _, gt, pred = _surface(2, 12, 15, 6)
    jfn = lambda p: getattr(JL, name)(p, jnp.asarray(gt))[0]  # noqa: E731
    leaf = _t(pred).requires_grad_()
    _check(getattr(losses, name)(leaf, _t(gt))[0], jfn(jnp.asarray(pred)), leaf, jax.grad(lambda p: jfn(p).sum())(
        jnp.asarray(pred)))


@pytest.mark.parametrize("name", ["mask_l2_loss", "mask_bce_loss", "mask_bce_logit_loss"])
def test_mask_losses_match_jax(name):
    rng = np.random.default_rng(7)
    logit = (rng.standard_normal((2, 9, 11)) * 4).astype(np.float32)
    value = logit if name == "mask_bce_logit_loss" else (1 / (1 + np.exp(-logit))).astype(np.float32)
    value[0, 0, :2] = [0.0, 1.0] if name == "mask_bce_loss" else value[0, 0, :2]  # saturated probabilities
    pos = rng.uniform(size=logit.shape) > 0.5
    neg = ~pos & (rng.uniform(size=logit.shape) > 0.3)
    jfn = lambda v: getattr(JL, name)(v, jnp.asarray(pos), jnp.asarray(neg))[0]  # noqa: E731
    leaf = _t(value).requires_grad_()
    _check(getattr(losses, name)(leaf, _t(pos), _t(neg))[0], jfn(jnp.asarray(value)), leaf,
           jax.grad(lambda v: jfn(v).sum())(jnp.asarray(value)))


def test_metric_scale_and_normal_map_losses_match_jax():
    rng = np.random.default_rng(8)
    pred_s = rng.uniform(0.5, 2, 4).astype(np.float32)
    gt_s = np.asarray([1.0, 0.0, 2.5, 0.7], np.float32)
    leaf = _t(pred_s).requires_grad_()
    _check(losses.metric_scale_loss(leaf, _t(gt_s))[0], JL.metric_scale_loss(jnp.asarray(pred_s), jnp.asarray(gt_s))[0],
           leaf, jax.grad(lambda p: JL.metric_scale_loss(p, jnp.asarray(gt_s))[0].sum())(jnp.asarray(pred_s)))
    pn, gn = rng.standard_normal((2, 2, 6, 7, 3)).astype(np.float32)
    gn[0, 0, 0] = np.inf
    leaf = _t(pn).requires_grad_()
    _check(losses.normal_map_loss(leaf, _t(gn))[0], JL.normal_map_loss(jnp.asarray(pn), jnp.asarray(gn))[0], leaf,
           jax.grad(lambda p: JL.normal_map_loss(p, jnp.asarray(gn))[0].sum())(jnp.asarray(pn)))
    np.testing.assert_allclose(losses.monitoring(_t(pn))["std"].numpy(), np.asarray(JL.monitoring(jnp.asarray(pn))["std"]),
                               rtol=TOL)


def _outputs_and_batch(b, h, w, seed):
    depth, intr, fin, _, pred = _surface(b, h, w, seed)
    rng = np.random.default_rng(seed + 100)
    out = {"points": pred,
           "normal": rng.standard_normal((b, h, w, 3)).astype(np.float32),
           "mask_logit": rng.standard_normal((b, h, w)).astype(np.float32),
           "metric_scale": rng.uniform(0.5, 2, b).astype(np.float32)}
    batch = {"depth": depth, "intrinsics": intr, "depth_mask_fin": fin,
             "depth_mask_inf": ~fin & (rng.uniform(size=fin.shape) > 0.5),
             "normal": rng.standard_normal((b, h, w, 3)).astype(np.float32), "normal_mask": np.ones_like(fin),
             "label_type_idx": np.asarray([1, 2, 1][:b], np.int32), "is_metric": np.asarray([True, False, True][:b])}
    return out, batch


@pytest.mark.parametrize("same_resolution", [False, True], ids=["separate_solves", "batched_solve"])
def test_compute_losses_with_local_losses_matches_jax(monkeypatch, same_resolution):
    """Every loss of the v2 label type 'A' table, local losses at two levels
    with the JAX draws injected; with one align_resolution both levels share
    one batched solve."""
    monkeypatch.setenv("MOGE_ANCHOR_WEIGHT_IMPL", "shift")
    out, batch = _outputs_and_batch(3, 40, 48, 9)
    loss_config = {"invalid": {}, "A": {
        "global": {"function": "affine_invariant_global_loss", "weight": 1.0, "params": {"align_resolution": 12}},
        "patch_4": {"function": "affine_invariant_local_loss", "weight": 1.0,
                    "params": {"level": 4, "align_resolution": 6, "num_patches": 8}},
        "patch_8": {"function": "affine_invariant_local_loss", "weight": 1.0,
                    "params": {"level": 8, "align_resolution": 6 if same_resolution else 4, "num_patches": 16}},
        "normal": {"function": "edge_loss", "weight": 1.0},
        "normal_map": {"function": "normal_map_loss", "weight": 0.1},
        "metric_scale": {"function": "metric_scale_loss", "weight": 0.1},
        "mask": {"function": "mask_bce_loss", "weight": 0.1}},
        "B": {"global": {"function": "affine_invariant_global_loss", "weight": 0.5,
                         "params": {"align_resolution": 12}},
              "mask": {"function": "mask_bce_loss", "weight": 0.1}}}
    label_types = ["invalid", "A", "B"]
    rng_key = jax.random.PRNGKey(11)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jfn(points):
        return jax_compute_losses(rng_key, {**{k: jnp.asarray(v) for k, v in out.items()}, "points": points},
                                  jbatch, loss_config, label_types)

    (total_j, metrics_j), grad_j = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jnp.asarray(out["points"]))
    gt_j = jnp.where(jbatch["depth_mask_fin"][..., None],
                     jgeo.depth_map_to_point_map(jbatch["depth"], jbatch["intrinsics"]), jnp.inf)
    focal = 1.0 / jnp.sqrt(1.0 / jbatch["intrinsics"][:, 0, 0] ** 2 + 1.0 / jbatch["intrinsics"][:, 1, 1] ** 2)
    draws, chain = [], rng_key
    for level, patches in ((4, 8), (8, 16)):
        chain, sub = jax.random.split(chain)
        draws += _jax_local_draws(sub, gt_j, focal, level, patches)
    queue = _inject(monkeypatch, draws)

    leaf = _t(out["points"]).requires_grad_()
    total_t, metrics_t = compute_losses(None, {**{k: _t(v) for k, v in out.items()}, "points": leaf},
                                        {k: _t(v) for k, v in batch.items()}, loss_config, label_types)
    assert not queue
    assert set(metrics_t) == set(metrics_j)
    assert float(metrics_j["patch_8"]) > 0
    for k in metrics_j:
        np.testing.assert_allclose(metrics_t[k].detach().numpy(), np.asarray(metrics_j[k]), rtol=1e-4, atol=TOL,
                                   err_msg=k)
    _check(total_t, total_j, leaf, grad_j)
