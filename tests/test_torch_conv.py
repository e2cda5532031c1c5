"""The port's 3x3 replicate conv (moge_tpu_torch.ops.conv) against the JAX
package's ``conv3x3_xla``, its up2 weight composition and its Pallas kernel
body (interpret mode). On the CPU the port runs its plain version, the
oracle kernel K3 is held against on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import moge_tpu.ops.conv as jax_conv
from moge_tpu_torch.ops import conv

torch.set_num_threads(1)

FP32_TOL = 1e-5  # fp32 on both sides; only the accumulation order differs


def _case(b, h, w, c, o, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(dtype)
    k = (rng.standard_normal((3, 3, c, o)) * (9 * c) ** -0.5).astype(dtype)
    bias = (rng.standard_normal(o) * 0.1).astype(np.float32)
    res = rng.standard_normal((b, h, w, o)).astype(dtype)
    return x, k, bias, res


@pytest.mark.parametrize("shape", [(1, 7, 5, 16, 32), (2, 37, 53, 32, 16), (1, 1, 1, 8, 12), (1, 9, 2, 64, 64)])
@pytest.mark.parametrize("relu,use_res", [(False, False), (True, True), (True, False)])
def test_plain_matches_conv3x3_xla(shape, relu, use_res):
    x, k, bias, res = _case(*shape, seed=sum(shape))
    r = res if use_res else None
    want = np.asarray(jax_conv.conv3x3_xla(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                           None if r is None else jnp.asarray(r), relu))
    got = conv.conv3x3_replicate(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias),
                                 None if r is None else torch.from_numpy(r), relu).numpy()
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("c,o", [(8, 4), (16, 3), (64, 32)])
def test_up2_weights_match(c, o):
    _, k, _, _ = _case(1, 1, 1, c, o, seed=c * o)
    want = np.asarray(jax_conv.up2_conv3_weights(jnp.asarray(k)))
    got = conv.up2_conv3_weights(torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("b,h,w,c,o", [(1, 5, 6, 8, 4), (2, 6, 3, 16, 3), (1, 4, 4, 64, 1)])
def test_up2_bilinear_matches(b, h, w, c, o):
    x, k, bias, _ = _case(b, h, w, c, o, seed=h * w + c)
    want = np.asarray(jax_conv.conv3x3_up2_bilinear(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias)))
    got = conv.conv3x3_up2_bilinear(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias)).numpy()
    assert got.shape == (b, 2 * h, 2 * w, o)
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("shape,relu,use_res", [
    ((1, 8, 8, 64, 64), True, True), ((1, 12, 10, 64, 32), False, False),
    ((1, 8, 8, 32, 32), True, False), ((1, 6, 10, 128, 128), False, True)])
def test_plain_matches_pallas_kernel_interpreted(shape, relu, use_res, monkeypatch):
    """bf16 in and out at the shapes the Pallas kernel supports. Both sides
    accumulate in fp32 and round once; they may differ by a bf16 ulp where
    the accumulation order tips the rounding."""
    x, k, bias, res = _case(*shape, seed=3 * sum(shape))
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
