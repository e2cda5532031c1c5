"""The port's grouped 3x3 replicate conv (weights (G, 3, 3, C, O), batch entry
b uses group b // B0) against the JAX package: ``conv3x3_xla`` with a 5-dim
kernel, the grouped Pallas kernel body in interpret mode, the up2 parity
expansion per group, and ``jax.vjp`` of ``conv3x3_xla``. On the CPU the port
runs its plain version, the oracle kernel K3-grouped is held against on the
card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moge_tpu.ops.conv as jax_conv
from moge_tpu_torch.ops import conv
from moge_tpu_torch.ops._vjp import plain_vjp

torch.set_num_threads(1)

FP32_TOL = 1e-5  # fp32 on both sides; only the accumulation order differs


def _case(g, b0, h, w, c, o, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g * b0, h, w, c)).astype(dtype)
    k = (rng.standard_normal((g, 3, 3, c, o)) * (9 * c) ** -0.5).astype(dtype)
    bias = (rng.standard_normal((g, o)) * 0.1).astype(np.float32)
    res = rng.standard_normal((g * b0, h, w, o)).astype(dtype)
    return x, k, bias, res


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", [(3, 1, 7, 5, 16, 32), (3, 2, 9, 6, 24, 20), (2, 3, 1, 1, 8, 12)])
@pytest.mark.parametrize("relu,use_res", [(False, False), (True, True)])
def test_grouped_plain_matches_conv3x3_xla(shape, relu, use_res):
    x, k, bias, res = _case(*shape, seed=sum(shape))
    r = res if use_res else None
    want = np.asarray(jax_conv.conv3x3_xla(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                           None if r is None else jnp.asarray(r), relu))
    got = conv.conv3x3_replicate(*_t(x, k, bias, r), relu).numpy()
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


def test_grouped_refuses_a_batch_the_groups_do_not_divide():
    x, k, bias, _ = _case(3, 1, 4, 4, 8, 4, seed=0)
    with pytest.raises(ValueError, match="multiple"):
        conv.conv3x3_replicate(torch.from_numpy(x[:2]), torch.from_numpy(k), torch.from_numpy(bias))
    with pytest.raises(ValueError, match="multiple"):
        conv.conv3x3_plain(torch.from_numpy(x[:2]), torch.from_numpy(k), torch.from_numpy(bias))


@pytest.mark.parametrize("shape,relu,use_res", [
    ((3, 1, 8, 8, 64, 64), True, True), ((3, 2, 12, 10, 64, 32), False, False),
    ((2, 2, 6, 10, 128, 128), False, True)])
def test_grouped_plain_matches_pallas_kernel_interpreted(shape, relu, use_res, monkeypatch):
    """bf16 in and out at shapes the grouped Pallas kernel supports: both
    accumulate in fp32 and round once, so they agree within one bf16 ulp."""
    x, k, bias, res = _case(*shape, seed=5 * sum(shape))
    xj, kj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    rj = jnp.asarray(res, jnp.bfloat16) if use_res else None
    assert jax_conv._supported(xj, kj)
    monkeypatch.setattr(jax_conv, "_INTERPRET", True)
    monkeypatch.setenv("MOGE_PALLAS_CONV", "1")
    want = np.asarray(jax_conv.conv3x3_replicate(xj, kj, jnp.asarray(bias), rj, relu).astype(jnp.float32))

    def to_torch(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)

    got = conv.conv3x3_replicate(to_torch(xj), to_torch(kj), torch.from_numpy(bias),
                                 None if rj is None else to_torch(rj), relu)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp + 1e-6)


@pytest.mark.parametrize("g,c,o", [(3, 8, 4), (2, 16, 3)])
def test_grouped_up2_weights_match_vmap(g, c, o):
    _, k, _, _ = _case(g, 1, 1, 1, c, o, seed=c * o)
    want = np.asarray(jax.vmap(jax_conv.up2_conv3_weights)(jnp.asarray(k)))
    got = conv.up2_conv3_weights(torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("g,b0,h,w,c,o", [(3, 1, 5, 6, 8, 4), (2, 2, 6, 3, 16, 3)])
def test_grouped_up2_bilinear_matches_per_group(g, b0, h, w, c, o):
    """The grouped fused up2 conv equals JAX's ``conv3x3_up2_bilinear`` run
    group by group (what ``multihead.py`` computes with vmapped weights)."""
    x, k, bias, _ = _case(g, b0, h, w, c, o, seed=h * w + c)
    want = np.concatenate([
        np.asarray(jax_conv.conv3x3_up2_bilinear(jnp.asarray(x[i * b0:(i + 1) * b0]), jnp.asarray(k[i]),
                                                 jnp.asarray(bias[i])))
        for i in range(g)])
    got = conv.conv3x3_up2_bilinear(*_t(x, k, bias)).numpy()
    assert got.shape == (g * b0, 2 * h, 2 * w, o)
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("relu,use_res", [(True, True), (False, False)])
def test_grouped_vjp_matches_jax(relu, use_res):
    """The gradient of every operand, through the plain version (the CPU
    path) and through ``plain_vjp`` (the backward of the card's autograd
    Function), against ``jax.vjp`` of ``conv3x3_xla`` in fp32."""
    x, k, bias, res = _case(3, 2, 6, 5, 8, 12, seed=11)
    r = res if use_res else None
    cot = np.random.default_rng(12).standard_normal((6, 6, 5, 12)).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, k, bias)] + ([jnp.asarray(r)] if use_res else [])
    _, vjp = jax.vjp(lambda *a: jax_conv.conv3x3_xla(*a[:3], a[3] if use_res else None, relu), *args)
    want = [np.asarray(gr) for gr in vjp(jnp.asarray(cot))]

    leaves = [t.requires_grad_() for t in _t(x, k, bias, r) if t is not None]
    out = conv.conv3x3_replicate(*leaves[:3], leaves[3] if use_res else None, relu)
    autograd = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    via_function = [gr for gr in plain_vjp(conv.conv3x3_plain, _t(x, k, bias, r), (True,) * 4,
                                           torch.from_numpy(cot), relu) if gr is not None]
    for got in (autograd, via_function):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4)
