"""The port's LayerNorm (moge_tpu_torch.ops.norm) against the JAX package's
``_ln_xla`` and its Pallas kernel body (interpret mode). On the CPU the port
runs its plain version, the oracle kernel K1 is held against on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import moge_tpu.ops.norm as jax_norm
from moge_tpu_torch.ops import norm

torch.set_num_threads(1)

FP32_TOL = 1e-5  # fp32 on both sides; only the reduction order differs


def _inputs(m, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, d)) * 3 + 1).astype(np.float32)
    s = rng.standard_normal(d).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    return x, s, b


@pytest.mark.parametrize("d", [192, 256, 1024])
def test_plain_matches_ln_xla(d):
    x, s, b = _inputs(37, d, d)  # M=37: ragged against every row block
    want = np.asarray(jax_norm._ln_xla(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-6))
    got = norm.layer_norm_fp32(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("d", [256, 1024])
def test_plain_matches_pallas_kernel_interpreted(d, monkeypatch):
    """The Pallas body engages at D % 128 == 0; ragged M against a 16-row block."""
    x, s, b = _inputs(37, d, 100 + d)
    monkeypatch.setattr(jax_norm, "_INTERPRET", True)
    monkeypatch.setattr(jax_norm, "_ROW_BLOCK", 16)
    monkeypatch.setenv("MOGE_PALLAS_LN", "1")
    want = np.asarray(jax_norm.layer_norm_fp32(jnp.asarray(x[None]), jnp.asarray(s), jnp.asarray(b)))[0]
    got = norm.layer_norm_fp32(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


def test_plain_bf16_rounds_once_like_ln_xla():
    """bf16 in and out: fp32 statistics and affine, one rounding. The two
    sides may differ by one bf16 ulp where fp32 reduction order tips it."""
    x, s, b = _inputs(53, 192, 7)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_norm._ln_xla(xj, jnp.asarray(s), jnp.asarray(b), 1e-6).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = norm.layer_norm_fp32(xt, torch.from_numpy(s), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp)


def test_leading_dims_kept():
    x, s, b = _inputs(2 * 3 * 5, 64, 3)
    got = norm.layer_norm_fp32(torch.from_numpy(x).reshape(2, 3, 5, 64), torch.from_numpy(s), torch.from_numpy(b))
    flat = norm.layer_norm_fp32(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b))
    assert got.shape == (2, 3, 5, 64)
    np.testing.assert_array_equal(got.reshape(-1, 64).numpy(), flat.numpy())
