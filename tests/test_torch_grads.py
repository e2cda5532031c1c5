"""Gradients of the port's kernel-backed ops and model against the JAX
package: LayerNorm, the 3x3 conv and attention (with ``kv_valid``) against
``jax.vjp`` of ``_ln_xla``, ``conv3x3_xla`` and ``sdpa_xla``, and the tiny
MoGe-2 forward's parameter gradients. On the CPU the port runs its plain
versions under autograd, the oracle the card's autograd Functions (K1/K3
forward with a plain backward, K2 with K2b-dq/K2b-dkv) are held against."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import moge_tpu.ops.conv as jax_conv
from moge_tpu.ops.attention import sdpa_xla
from moge_tpu.ops.norm import _ln_xla
from moge_tpu_torch.models.v2 import MoGeV2
from moge_tpu_torch.ops import attention, conv, norm
from torch_tiny_config import TINY_CONFIG

torch.set_num_threads(1)

GRAD_TOL = 1e-5  # fp32 on both sides; only the reduction order differs


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _grads(fn, *inputs):
    """Gradients of sum(fn(*inputs) * cot) w.r.t. each input, cot seeded."""
    leaves = [_t(a).requires_grad_() for a in inputs]
    out = fn(*leaves)
    cot = np.random.default_rng(99).standard_normal(tuple(out.shape)).astype(np.float32)
    return torch.autograd.grad(out, leaves, _t(cot)), cot


@pytest.mark.parametrize("m,d", [(37, 192), (5, 1000)])
def test_layer_norm_vjp_matches_jax(m, d):
    rng = np.random.default_rng(m + d)
    x = (rng.standard_normal((m, d)) * 3 + 1).astype(np.float32)
    s, b = rng.standard_normal(d).astype(np.float32), rng.standard_normal(d).astype(np.float32)
    got, cot = _grads(lambda *a: norm.layer_norm_fp32(*a), x, s, b)
    _, vjp = jax.vjp(lambda *a: _ln_xla(*a, 1e-6), jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    for g, w in zip(got, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(w).max())


@pytest.mark.parametrize("relu,use_res", [(False, False), (True, True), (True, False)])
def test_conv3x3_vjp_matches_jax(relu, use_res):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 7, 16)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 16, 12)) / 12).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    res = rng.standard_normal((2, 9, 7, 12)).astype(np.float32)
    args = (x, k, bias) + ((res,) if use_res else ())
    got, cot = _grads(lambda x_, k_, b_, *r: conv.conv3x3_replicate(x_, k_, b_, r[0] if r else None, relu), *args)
    _, vjp = jax.vjp(lambda x_, k_, b_, *r: jax_conv.conv3x3_xla(x_, k_, b_, r[0] if r else None, relu),
                     *map(jnp.asarray, args))
    for g, w in zip(got, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(w).max())


def test_up2_expanded_weights_carry_the_gradient():
    """The fused up2 path trains the original 3x3 weights: gradient of the
    low-resolution conv over parity-expanded weights = gradient of the JAX
    package's bilinear-upsample-then-conv."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 6, 5, 8)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 8, 4)) / 8).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    got, cot = _grads(conv.conv3x3_up2_bilinear, x, k, bias)
    _, vjp = jax.vjp(jax_conv.conv3x3_up2_bilinear, *map(jnp.asarray, (x, k, bias)))
    for g, w in zip(got, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(w).max())


@pytest.mark.parametrize("b,n,h,kv_valid", [(2, 37, 3, None), (1, 50, 2, 31), (1, 9, 1, 1)])
def test_attention_vjp_matches_sdpa_xla(b, n, h, kv_valid):
    """The qkv entry the encoder uses, keys at or past kv_valid masked: one dqkv."""
    rng = np.random.default_rng(n)
    qkv = rng.standard_normal((b, n, 3, h, 64)).astype(np.float32)
    got, cot = _grads(lambda t: attention.flash_attention_qkv(t, kv_valid), qkv)
    _, vjp = jax.vjp(lambda t: sdpa_xla(t[:, :, 0], t[:, :, 1], t[:, :, 2], kv_valid=kv_valid), jnp.asarray(qkv))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    np.testing.assert_allclose(got[0].numpy(), want, rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(want).max())
    if kv_valid is not None:
        assert not got[0][:, kv_valid:, 1:].any()


def test_flash_attention_bwd_plain_matches_autograd():
    """The backward entry chip_smoke.py holds K2b against, on the CPU."""
    rng = np.random.default_rng(4)
    q, k, v, dout = (_t(rng.standard_normal((1, 21, 2, 64))) for _ in range(4))
    out, lse = attention.flash_attention_fwd(q, k, v, 15)
    got = attention.flash_attention_bwd(q, k, v, out, lse, dout, 15)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention.attention_plain(*leaves, 15), leaves, dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_trainable_parameter_gets_a_gradient(dtype, remat):
    """loss.backward() on the training forward reaches every trainable
    parameter, also through the cast, folded and parity-expanded weights
    that inference caches, and twice in a row after an in-place update;
    also when the blocks, residual blocks and resamplers run as activation
    checkpoints (``remat``), which rebuild those weights in the backward."""
    module = MoGeV2(**TINY_CONFIG, remat=remat).init_random(seed=0)
    image = _t(np.random.default_rng(0).uniform(0, 1, (2, 56, 70, 3)))
    trainable = {n for n, p in module.named_parameters() if p.requires_grad}
    assert trainable == {n for n, _ in module.named_parameters()} - {"encoder.backbone.mask_token"}
    for _ in range(2):
        out = module(image, 20, dtype)
        assert set(out) == {"points", "normal", "mask_logit", "mask", "metric_scale"}
        loss = sum(v.float().square().mean() for v in out.values())
        loss.backward()
        missing = [n for n, p in module.named_parameters() if p.requires_grad and p.grad is None]
        assert not missing
        assert all(torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0
                   for p in module.parameters() if p.requires_grad)
        with torch.no_grad():
            for p in module.parameters():
                if p.requires_grad:
                    p -= 1e-3 * p.grad
                    p.grad = None
