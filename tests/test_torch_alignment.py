"""The port's alignment solvers (moge_tpu_torch.ops.alignment) against the
JAX package: the plain dense truncated-L1 objective (K4's oracle) against the
Pallas kernel body in interpret mode, and every public solver, values,
chosen indices and gradients, against ``moge_tpu.ops.alignment`` with its
CPU defaults (the dense form on the XLA evaluator)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moge_tpu.ops import alignment as jal
from moge_tpu_torch.ops import alignment

torch.set_num_threads(1)

FP32_TOL = 1e-5   # fp32 on both sides; sums in another order
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _jax_defaults(monkeypatch):
    """The JAX package's CPU defaults: the dense form, XLA evaluator."""
    monkeypatch.setenv("MOGE_ALIGN_TRUNC_IMPL", "auto")
    monkeypatch.setenv("MOGE_ALIGN_DENSE_KERNEL", "auto")


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("r,length,per_term", [(3, 50, False), (2, 300, True), (9, 130, False), (1, 1, False)])
def test_dense_objective_plain_matches_pallas_body(r, length, per_term):
    rng = np.random.default_rng(r * length)
    wx, wy, A = rng.standard_normal((3, r, length)).astype(np.float32)
    t = (rng.uniform(0.5, 1.5, (r, length)) if per_term else np.full((r, length), 1.0)).astype(np.float32)
    want = np.asarray(jal._dense_objective_pallas(*map(jnp.asarray, (A, wx, wy, t)), interpret=True))
    got = alignment.dense_objective(_t(A), _t(wx), _t(wy), _t(t) if per_term else 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL * np.abs(want).max())


def _problem(shape, seed, negative=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if not negative:
        x = np.abs(x) + 0.1
    y = (1.7 * x + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    w = rng.uniform(0, 1, shape).astype(np.float32) * (rng.uniform(size=shape) > 0.2)
    return x, y, w


@pytest.mark.parametrize("trunc", [None, 1.0, "per_term"])
@pytest.mark.parametrize("shape", [(4, 37), (2, 3, 60)])
def test_align_matches_jax(trunc, shape):
    x, y, w = _problem(shape, sum(shape))
    if trunc == "per_term":
        trunc = np.random.default_rng(1).uniform(0.2, 2.0, shape).astype(np.float32)
    jt = None if trunc is None else jnp.asarray(trunc)
    tt = None if trunc is None else (_t(trunc) if isinstance(trunc, np.ndarray) else trunc)
    a_j, loss_j, idx_j = jal.align(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), jt)
    leaves = [_t(v).requires_grad_() for v in (x, y)]
    a_t, loss_t, idx_t = alignment.align(*leaves, _t(w), tt)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(a_t.detach().numpy(), np.asarray(a_j), rtol=FP32_TOL)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=FP32_TOL, atol=FP32_TOL)
    # gradients through a = y[idx] / x[idx] only
    gx, gy = jax.grad(lambda x_, y_: jal.align(x_, y_, jnp.asarray(w), jt)[0].sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    got = torch.autograd.grad(a_t.sum(), leaves)
    for g, want in zip(got, (gx, gy)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=GRAD_TOL, atol=GRAD_TOL)


def _points(b, n, seed, scale=1.3, shift=(0.1, -0.2, 0.5)):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((b, n, 3)).astype(np.float32)
    src[..., 2] = np.abs(src[..., 2]) + 1.0
    tgt = (scale * src + np.asarray(shift, np.float32) + 0.05 * rng.standard_normal((b, n, 3))).astype(np.float32)
    w = rng.uniform(0, 1, (b, n)).astype(np.float32) * (rng.uniform(size=(b, n)) > 0.3)
    return src, tgt, w


@pytest.mark.parametrize("name", ["align_points_scale_z_shift", "align_points_scale_xyz_shift",
                                  "align_points_scale", "align_points_z_shift", "align_points_xyz_shift"])
@pytest.mark.parametrize("trunc", [None, 1.0])
def test_point_solvers_match_jax(name, trunc):
    src, tgt, w = _points(3, 40, len(name))
    jfn, tfn = getattr(jal, name), getattr(alignment, name)
    want = jfn(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w), trunc)
    leaves = [_t(v).requires_grad_() for v in (src, tgt)]
    got = tfn(*leaves, _t(w), trunc)
    want, got = (want if isinstance(want, tuple) else (want,)), (got if isinstance(got, tuple) else (got,))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(wv), rtol=FP32_TOL, atol=FP32_TOL)
    jgrads = jax.grad(lambda s, t: sum(v.sum() for v in jax.tree.leaves(jfn(s, t, jnp.asarray(w), trunc))),
                      argnums=(0, 1))(jnp.asarray(src), jnp.asarray(tgt))
    tgrads = torch.autograd.grad(sum(v.sum() for v in got), leaves, allow_unused=True)
    for g, wv in zip(tgrads, jgrads):
        g = np.zeros_like(np.asarray(wv)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(wv), rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("trunc", [None, 1.0])
def test_depth_solvers_match_jax(trunc):
    rng = np.random.default_rng(11)
    src = rng.uniform(1, 3, (2, 3, 30)).astype(np.float32)
    tgt = (0.8 * src + 0.4 + 0.05 * rng.standard_normal(src.shape)).astype(np.float32)
    w = rng.uniform(0, 1, src.shape).astype(np.float32)
    for name in ("align_depth_scale", "align_depth_affine"):
        want = getattr(jal, name)(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w), trunc)
        got = getattr(alignment, name)(_t(src), _t(tgt), _t(w), trunc)
        for g, wv in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=FP32_TOL, atol=FP32_TOL)


def test_affine_lstsq_matches_jax():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 50)).astype(np.float32)
    y = (2.0 * x - 1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    w = rng.uniform(0, 1, x.shape).astype(np.float32)
    for weight in (None, w):
        want = jal.align_affine_lstsq(jnp.asarray(x), jnp.asarray(y), None if weight is None else jnp.asarray(weight))
        got = alignment.align_affine_lstsq(_t(x), _t(y), None if weight is None else _t(weight))
        for g, wv in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-4, atol=1e-5)


def test_solves_are_recorded_when_asked(monkeypatch):
    """``SOLVES`` collects each anchor solve's (scale, shift, anchor, index)."""
    monkeypatch.setattr(alignment, "SOLVES", [])
    src, tgt, w = _points(2, 20, 3)
    scale, shift = alignment.align_points_scale_z_shift(_t(src), _t(tgt), _t(w), 1.0)
    (rec,) = alignment.SOLVES
    assert torch.equal(rec[0], scale) and torch.equal(rec[1], shift)
    assert rec[2].shape == rec[3].shape == (2,)
