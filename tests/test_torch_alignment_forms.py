"""The sorted truncated-align forms of the port (``events``, ``prefix``)
and its bitonic network (``moge_tpu_torch.ops.bitonic``) against the JAX
package's same forms, on seeded numpy inputs: chosen indices equal, ``a``,
``loss`` and the gradients of ``a`` within the stated tolerances, through
``align`` and the three anchor solvers; the adversarial cases of the JAX
package's own form tests against a brute-force minimum; and the form
selection. Both packages read ``MOGE_ALIGN_TRUNC_IMPL``, set here per test.
JAX's events form sorts by its bitonic network when ``MOGE_BITONIC_MAX``
allows, else by ``lax.sort``; the port's always by ``torch.sort``, which
must give the same result against either. JAX's dense form runs on its XLA
evaluator."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moge_tpu.ops import alignment as jal
from moge_tpu.ops import bitonic as jbitonic
from moge_tpu_torch.ops import alignment, bitonic

torch.set_num_threads(1)

FP32_TOL = 1e-5   # fp32 on both sides; prefix sums in another order
GRAD_TOL = 1e-5
# prefix computes F as a difference of A x prefix(wx) terms, so a near-flat
# row carries fp32 cancellation error of order eps_32 * max|A| * sum w|x|:
# JAX's own form tests allow 4e-7 of that scale (tests/test_alignment_impls.py)
PREFIX_CANCEL = 4e-7

# (MOGE_ALIGN_TRUNC_IMPL, MOGE_BITONIC_MAX): events against JAX's on its
# sort and on its bitonic network, and prefix
FORMS = {"events_sort": ("events", "0"), "events_bitonic": ("events", "1000000"), "prefix": ("prefix", "0")}


@pytest.fixture(autouse=True)
def _xla_dense(monkeypatch):
    monkeypatch.setenv("MOGE_ALIGN_DENSE_KERNEL", "xla")


def _select(monkeypatch, form):
    impl, bitonic_max = FORMS[form]
    monkeypatch.setenv("MOGE_ALIGN_TRUNC_IMPL", impl)
    monkeypatch.setenv("MOGE_BITONIC_MAX", bitonic_max)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cancel_scale(x, y, w):
    """Per row: max |A| * sum w|x|, the scale of prefix's cancellation error."""
    return np.abs(y / np.maximum(np.abs(x), 1e-7)).max(-1) * (w * np.abs(x)).sum(-1)


def _loss_atol(form, x, y, w):
    return FP32_TOL + (PREFIX_CANCEL * _cancel_scale(x, y, w) if form == "prefix" else 0.0)


def _assert_loss_close(got, want, atol, rtol=FP32_TOL):
    """|got - want| <= atol + rtol |want| elementwise; ``atol`` per row."""
    err = np.abs(got.astype(np.float64) - want)
    bad = err > atol + rtol * np.abs(want)
    limit = np.broadcast_to(atol, err.shape)
    assert not bad.any(), f"loss off at {np.argwhere(bad).tolist()}: {err[bad]} > {limit[bad]}"


# ---------------------------------------------------------------------------
# the bitonic network and the stable sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5,), (3, 7), (2, 3, 16), (4, 1), (2, 33), (1, 100)])
def test_sort_with_payloads_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    keys = rng.integers(0, 6, shape).astype(np.float32)  # ties everywhere
    keys[..., ::5] = rng.standard_normal(keys[..., ::5].shape)
    p_int = rng.integers(-50, 50, shape).astype(np.int32)
    p_f32 = rng.standard_normal(shape).astype(np.float32)
    want = jax.jit(jbitonic.sort_with_payloads)(jnp.asarray(keys), [jnp.asarray(p_int), jnp.asarray(p_f32)])
    got = bitonic.sort_with_payloads(_t(keys), [_t(p_int), _t(p_f32)])
    for g, wv in zip(got, want):
        assert g.shape == shape and g.dtype == _t(np.asarray(wv)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    # a stable sort's permutation
    order = torch.sort(_t(keys), dim=-1, stable=True).indices
    np.testing.assert_array_equal(got[0].numpy(), np.take_along_axis(keys, order.numpy(), -1))
    np.testing.assert_array_equal(got[1].numpy(), np.take_along_axis(p_int, order.numpy(), -1))
    np.testing.assert_array_equal(got[2].numpy(), np.take_along_axis(p_f32, order.numpy(), -1))


def _special_keys():
    """Signed-zero ties, infinities and NaNs of both signs."""
    k = np.array([[0.0, -0.0, 1.0, np.nan, -np.nan, -0.0, 0.0, -1.0, np.inf, np.nan, -np.inf, 0.0, 2.0, np.inf],
                  [-0.0, -0.0, 0.0, 0.0, 3.0, -3.0, 0.0, -0.0, 1.0, 1.0, -0.0, 0.0, 0.0, -0.0]], np.float32)
    return k, np.broadcast_to(np.arange(k.shape[-1], dtype=np.int32), k.shape).copy()


def test_stable_sort_orders_signed_zeros_and_nans_as_lax_sort():
    keys, pos = _special_keys()
    want = jax.lax.sort((jnp.asarray(keys), jnp.asarray(pos)), dimension=-1, is_stable=True, num_keys=1)
    got = alignment.sort_stable(_t(keys), [_t(pos)])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # NaNs compare equal here


def test_bitonic_orders_signed_zeros_and_nans_as_jaxs_network():
    keys, pos = _special_keys()
    want = jax.jit(jbitonic.sort_with_payloads)(jnp.asarray(keys), [jnp.asarray(pos)])
    got = bitonic.sort_with_payloads(_t(keys), [_t(pos)])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


# ---------------------------------------------------------------------------
# align: the sorted forms against JAX's same forms
# ---------------------------------------------------------------------------

def _problem(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    y = (1.7 * x + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    w = rng.uniform(0, 1, shape).astype(np.float32) * (rng.uniform(size=shape) > 0.2)
    return x, y, w


def _jax_with_grads(fn, *args):
    """``fn(*args)`` of the JAX package, jitted afresh (so that it reads the
    environment's form now), and the gradients of the sum of its outputs
    (their floating ones) by the arguments."""
    def total(*a):
        out = fn(*a)
        return sum(v.sum() for v in jax.tree.leaves(out) if jnp.issubdtype(v.dtype, jnp.floating)), out

    (_, out), grads = jax.jit(jax.value_and_grad(total, argnums=tuple(range(len(args))), has_aux=True))(*args)
    return out, grads


def _check_against_jax(form, x, y, w, trunc, grads=True):
    """The port's align under the selected form against JAX's: index equal,
    a and loss within tolerance, and the gradients of sum(a) by x and y
    (the loss carries none on either side)."""
    jt = jnp.asarray(trunc)
    tt = _t(trunc) if isinstance(trunc, np.ndarray) else trunc
    (a_j, loss_j, idx_j), jgrads = _jax_with_grads(lambda x_, y_: jal.align(x_, y_, jnp.asarray(w), jt),
                                                   jnp.asarray(x), jnp.asarray(y))
    leaves = [_t(v).requires_grad_() for v in (x, y)]
    a_t, loss_t, idx_t = alignment.align(*leaves, _t(w), tt)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(a_t.detach().numpy(), np.asarray(a_j), rtol=FP32_TOL)
    _assert_loss_close(loss_t.numpy(), np.asarray(loss_j), _loss_atol(form, x, y, w))
    assert not loss_t.requires_grad and not idx_t.requires_grad
    if grads:
        for g, want in zip(torch.autograd.grad(a_t.sum(), leaves), jgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("trunc", ["scalar", "per_element"])
@pytest.mark.parametrize("shape", [(4, 37), (2, 3, 60)])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_align_form_matches_jax(monkeypatch, form, shape, trunc):
    _select(monkeypatch, form)
    x, y, w = _problem(shape, sum(shape))
    t = 1.0 if trunc == "scalar" else np.random.default_rng(1).uniform(0.2, 2.0, shape).astype(np.float32)
    _check_against_jax(form, x, y, w, t)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_align_form_with_signed_zero_candidates_matches_jax(monkeypatch, form):
    """Zero targets under negative x give -0.0 candidates beside 0.0 ones
    (ys = y * sign(x)): tied keys whose order the sorts must agree on."""
    _select(monkeypatch, form)
    x, y, w = _problem((3, 40), 7)
    y[:, ::4] = 0.0
    x[:, ::8] = -np.abs(x[:, ::8])
    _check_against_jax(form, x, y, w, 0.8)


def _adversarial_cases():
    """The cases of the JAX package's form tests, rebuilt from seed 123."""
    rng = np.random.default_rng(123)
    cases = {}
    x = rng.standard_normal((4, 24)).astype(np.float32) + 2.0
    y = (x * 1.5 + rng.standard_normal((4, 24)) * 0.3).astype(np.float32)
    w = np.abs(rng.standard_normal((4, 24))).astype(np.float32)
    cases["random"] = (x, y, w, 0.7)
    # ties at breakpoints: few distinct candidates, each repeated, exact fit
    x = np.tile(np.array([1.0, 2.0, 2.0, 2.0, 3.0, 3.0], np.float32), (2, 4))
    y = x * np.array([[2.0], [0.5]], np.float32)
    cases["ties"] = (x, y, np.ones_like(x), 0.5)
    # near-flat objective: every term truncated (tiny trunc, bad fit)
    x = rng.standard_normal((3, 16)).astype(np.float32) + 3.0
    y = rng.uniform(50, 100, (3, 16)).astype(np.float32)
    cases["all_truncated"] = (x, y, np.ones_like(x), 1e-3)
    x = rng.standard_normal((3, 20)).astype(np.float32)
    y = (x * -0.8 + rng.standard_normal((3, 20)) * 0.1).astype(np.float32)
    w = np.abs(rng.standard_normal((3, 20))).astype(np.float32)
    cases["negative_x"] = (x, y, w, 0.9)
    x = rng.standard_normal((4, 18)).astype(np.float32) + 2.0
    y = (x * 1.2 + rng.standard_normal((4, 18)) * 0.2).astype(np.float32)
    w = np.abs(rng.standard_normal((4, 18))).astype(np.float32)
    w[1] = 0.0
    w[:, ::3] = 0.0
    cases["zero_weights"] = (x, y, w, 0.6)
    return cases


CASES = _adversarial_cases()


def _objective(a, x, y, w, trunc):
    """sum_i min(trunc, w_i |a x_i - y_i|) in float64, for each a (..., k)."""
    x, y, w = (v.astype(np.float64)[..., None, :] for v in (x, y, w))
    return np.minimum(trunc, w * np.abs(a[..., :, None] * x - y)).sum(-1)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_align_form_attains_the_brute_force_minimum(monkeypatch, form, case):
    x, y, w, trunc = CASES[case]
    _select(monkeypatch, form)
    a, loss, index = (v.detach().numpy() for v in alignment.align(_t(x), _t(y), _t(w), trunc))
    sign = np.sign(x)
    xs, ys = x * sign, y * sign
    cand = (ys / np.maximum(xs, 1e-7)).astype(np.float64)
    f_min = _objective(cand, x, y, w, trunc).min(-1)
    atol = max(1e-4, float(np.max(_loss_atol(form, x, y, w))))
    _assert_loss_close(loss, f_min, atol, rtol=1e-5)
    np.testing.assert_allclose(_objective(a[..., None], x, y, w, trunc)[..., 0], f_min, rtol=1e-4, atol=atol)
    np.testing.assert_allclose(a, np.take_along_axis(ys, index[..., None], -1)[..., 0]
                               / np.maximum(np.take_along_axis(xs, index[..., None], -1)[..., 0], 1e-7), rtol=1e-6)
    # and JAX's same form chooses the same index: for events, which evaluates
    # F directly; prefix's choice among candidates within its cancellation
    # error of the minimum (the all-truncated rows) follows the rounding of
    # its prefix sums, which the JAX package sums in another order
    if form != "prefix":
        _check_against_jax(form, x, y, w, trunc, grads=False)


# ---------------------------------------------------------------------------
# the anchor solvers under each form
# ---------------------------------------------------------------------------

def _points(b, n, seed):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((b, n, 3)).astype(np.float32)
    src[..., 2] = np.abs(src[..., 2]) + 1.0
    tgt = (1.3 * src + np.asarray([0.1, -0.2, 0.5], np.float32)
           + 0.05 * rng.standard_normal((b, n, 3))).astype(np.float32)
    w = rng.uniform(0, 1, (b, n)).astype(np.float32) * (rng.uniform(size=(b, n)) > 0.3)
    return src, tgt, w


@pytest.mark.parametrize("name", ["align_points_scale_z_shift", "align_points_scale_xyz_shift"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_point_solvers_under_form_match_jax(monkeypatch, form, name):
    _select(monkeypatch, form)
    src, tgt, w = _points(3, 40, len(name))
    jfn, tfn = getattr(jal, name), getattr(alignment, name)
    want, jgrads = _jax_with_grads(lambda s, t: jfn(s, t, jnp.asarray(w), 1.0), jnp.asarray(src), jnp.asarray(tgt))
    leaves = [_t(v).requires_grad_() for v in (src, tgt)]
    got = tfn(*leaves, _t(w), 1.0)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(wv), rtol=FP32_TOL, atol=FP32_TOL)
    for g, wv in zip(torch.autograd.grad(sum(v.sum() for v in got), leaves), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=GRAD_TOL, atol=GRAD_TOL)


def _depth_problem(case):
    """``random``: noisy affine depths. ``tied``: in each row two lines
    through the first point (y = x and y = 2x - 1) hold two more points each
    and a sixth point lies off both, so with trunc 0.5 both lines attain the
    minimum 3 t exactly: the forms break the tie otherwise (dense and prefix
    by original index, events by value), and the rows put the steeper line's
    points first or last."""
    if case == "tied":
        src = np.array([[1, 4, 5, 2, 3, 6], [1, 2, 3, 4, 5, 6]], np.float32)
        tgt = np.array([[1, 7, 9, 2, 3, 0], [1, 2, 3, 7, 9, 0]], np.float32)
        return src, tgt, np.ones_like(src), 0.5
    rng = np.random.default_rng(11)
    src = rng.uniform(1, 3, (2, 3, 30)).astype(np.float32)
    tgt = (0.8 * src + 0.4 + 0.05 * rng.standard_normal(src.shape)).astype(np.float32)
    return src, tgt, rng.uniform(0, 1, src.shape).astype(np.float32), 1.0


@pytest.mark.parametrize("case", ["random", "tied"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_depth_affine_under_form_matches_jax(monkeypatch, form, case):
    _select(monkeypatch, form)
    src, tgt, w, trunc = _depth_problem(case)
    # a fresh function, so that JAX traces it now and reads this form
    want = jax.jit(lambda s, t, w_: jal.align_depth_affine(s, t, w_, trunc))(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))
    got = alignment.align_depth_affine(_t(src), _t(tgt), _t(w), trunc)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=FP32_TOL, atol=FP32_TOL)


# ---------------------------------------------------------------------------
# the selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["sorted", "Events", ""])
def test_unknown_form_raises_in_both_packages(monkeypatch, impl):
    monkeypatch.setenv("MOGE_ALIGN_TRUNC_IMPL", impl)
    with pytest.raises(ValueError, match="MOGE_ALIGN_TRUNC_IMPL"):
        jal.align(jnp.ones((2, 8)), jnp.ones((2, 8)), jnp.ones((2, 8)), trunc=0.5)
    with pytest.raises(ValueError, match="MOGE_ALIGN_TRUNC_IMPL"):
        alignment.align(torch.ones(2, 8), torch.ones(2, 8), torch.ones(2, 8), trunc=0.5)


@pytest.mark.parametrize("impl", [None, "auto", "dense"])
def test_auto_and_dense_take_the_dense_objective(monkeypatch, impl):
    """The default form is the dense one (K4 on the card): the plain dense
    objective runs, and neither sort does."""
    if impl is None:
        monkeypatch.delenv("MOGE_ALIGN_TRUNC_IMPL", raising=False)
    else:
        monkeypatch.setenv("MOGE_ALIGN_TRUNC_IMPL", impl)
    calls = []
    monkeypatch.setattr(alignment, "dense_objective_plain",
                        lambda *a, plain=alignment.dense_objective_plain: calls.append(1) or plain(*a))
    monkeypatch.setattr(alignment, "sort_stable", None)
    monkeypatch.setattr(bitonic, "sort_with_payloads", None)
    x, y, w = _problem((3, 20), 3)
    alignment.align(_t(x), _t(y), _t(w), 1.0)
    assert calls == [1]


@pytest.mark.parametrize("bitonic_max", ["0", "59", "60", "4096"])
def test_events_sorts_by_torch_sort_whatever_bitonic_max(monkeypatch, bitonic_max):
    """The port's events form takes the stable sort at every
    MOGE_BITONIC_MAX, also where JAX's would take its network (3n <= the
    value; n = 20 here): the result is the same."""
    monkeypatch.setenv("MOGE_ALIGN_TRUNC_IMPL", "events")
    monkeypatch.setenv("MOGE_BITONIC_MAX", bitonic_max)
    used = []
    for mod, name in ((bitonic, "sort_with_payloads"), (alignment, "sort_stable")):
        monkeypatch.setattr(mod, name, lambda *a, f=getattr(mod, name), n=name: used.append(n) or f(*a))
    x, y, w = _problem((3, 20), 4)
    alignment.align(_t(x), _t(y), _t(w), 1.0)
    assert used == ["sort_stable"]


@pytest.mark.parametrize("impl,device,want", [
    ("dense", "cuda", 4608),                         # every pair in one K4 launch
    ("auto", "cuda", 4608),
    ("events", "cuda", (1 << 24) // 6912),            # the sorted forms' budget on the card
    ("prefix", "cuda", (1 << 24) // 6912),
    ("events", "cpu", max(128, (1 << 22) // 6912)),   # the CPU budget, whatever the form
])
def test_anchor_chunks_by_form(monkeypatch, impl, device, want):
    """Pairs per chunk of the global loss's solve at batch 2 (4608 pairs of
    length 6912): the dense form's chunking on the card is unchanged."""
    monkeypatch.setenv("MOGE_ALIGN_TRUNC_IMPL", impl)
    assert alignment._chunk_pairs(4608, 6912, 1.0, torch.device(device)) == want
    assert alignment._chunk_pairs(4608, 6912, None, torch.device(device)) == \
        (4608 if device == "cuda" else max(128, (1 << 22) // 6912))


def test_dense_objective_entry_is_typed_once(monkeypatch):
    """K4's C entry gets its argtypes at first load only."""
    class Entry:
        pass

    loads = []
    lib = type("Lib", (), {"moge_dense_objective": Entry()})()
    monkeypatch.setattr(alignment._build, "load", lambda name: loads.append(name) or lib)
    monkeypatch.setattr(alignment.K4, "_fn", None)
    monkeypatch.setattr(alignment.K4, "_lib", None)
    assert alignment.K4.function() is alignment.K4.function() is lib.moge_dense_objective
    assert loads == ["dense_align"] and len(lib.moge_dense_objective.argtypes) == 9
