"""The port's attention (moge_tpu_torch.ops.attention) against the JAX
package's ``sdpa_xla`` and its Pallas flash kernel (TPU interpret mode). On
the CPU the port runs its plain version, the oracle kernel K2 is held
against on the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from moge_tpu.ops.attention import flash_attention as jax_flash, sdpa_xla
from moge_tpu_torch.ops import attention

torch.set_num_threads(1)

FP32_TOL = 1e-5          # fp32 on both sides; only the reduction order differs
FLASH_RTOL, FLASH_ATOL = 2e-3, 2e-4  # the Pallas kernel's own tolerance vs sdpa_xla (tests/test_attention.py)
BWD_REL = 1e-5  # fp32 gradients relative to the largest gradient: reduction order only (reads < 1e-6)


def _qkv(b, nq, nkv, h, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nq, h, 64)).astype(np.float32)
    k = rng.standard_normal((b, nkv, h, 64)).astype(np.float32)
    v = rng.standard_normal((b, nkv, h, 64)).astype(np.float32)
    return q, k, v


def _port(q, k, v, kv_valid=None, **kw):
    return attention.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                         kv_valid, **kw)


@pytest.mark.parametrize("b,nq,nkv,h,kv_valid", [
    (1, 37, 37, 3, None), (2, 130, 130, 2, None), (1, 37, 64, 2, 50), (1, 65, 65, 2, 1)])
def test_plain_matches_sdpa_xla(b, nq, nkv, h, kv_valid):
    q, k, v = _qkv(b, nq, nkv, h, nq + nkv)
    want = np.asarray(sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_valid=kv_valid))
    got, lse = _port(q, k, v, kv_valid)
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL, atol=FP32_TOL)
    # LSE: fp32 logsumexp over the valid keys
    n_ok = nkv if kv_valid is None else kv_valid
    logits = np.einsum("bnhd,bmhd->bhnm", q, k[:, :n_ok]).astype(np.float64) / 8.0
    mx = logits.max(-1, keepdims=True)
    want_lse = (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("b,n,h,kv_valid", [(1, 300, 2, None), (2, 130, 2, None), (1, 257, 2, 200)])
def test_plain_matches_pallas_flash_interpreted(b, n, h, kv_valid):
    """Ragged N (padded to the 128 block inside the Pallas kernel) and kv_valid."""
    q, k, v = _qkv(b, n, n, h, 7 * n)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    q_block=128, k_block=128, kv_valid=kv_valid))
    got, _ = _port(q, k, v, kv_valid)
    np.testing.assert_allclose(got.numpy(), want, rtol=FLASH_RTOL, atol=FLASH_ATOL)


@pytest.mark.parametrize("n,kv_valid", [(130, None), (130, 100), (257, None), (257, 100)])
def test_plain_backward_matches_pallas_flash_interpreted(n, kv_valid):
    """The port's backward on the CPU (``flash_attention_bwd``: autograd
    through the plain version) against ``jax.grad`` through the Pallas flash
    kernel, whose VJP is the K2b-dq/K2b-dkv Pallas kernels (TPU interpret
    mode), fp32, 2 heads, ragged N (padded to the 128 block inside the
    Pallas kernels) and kv_valid; masked keys get exactly zero dk and dv."""
    q, k, v = _qkv(1, n, n, 2, 11 * n)
    dout = np.random.default_rng(n).standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, q_block=128, k_block=128, kv_valid=kv_valid) * dout)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, lse = _port(q, k, v, kv_valid)
    got = attention.flash_attention_bwd(*(torch.from_numpy(t) for t in (q, k, v)), out, lse,
                                        torch.from_numpy(dout), kv_valid)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= BWD_REL, (name, err)
    if kv_valid is not None:
        assert not got[1][:, kv_valid:].any() and not got[2][:, kv_valid:].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_delta_is_the_fp32_rowsum(dtype):
    """delta (B, H, N) = rowsum(dO * O) over the head dim, in fp32, from
    strided bf16 or fp32 views (the products of two bf16 values are exact)."""
    rng = np.random.default_rng(5)
    both = torch.from_numpy(rng.standard_normal((2, 77, 2, 3, 64)).astype(np.float32)).to(dtype)
    out, dout = both[:, :, 0], both[:, :, 1]
    got = attention.attention_bwd_delta(out, dout)
    want = np.einsum("bnhd,bnhd->bhn", out.double().numpy(), dout.double().numpy())
    assert got.dtype == torch.float32 and got.is_contiguous() and got.shape == (2, 3, 77)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_strided_qkv_views_match_contiguous():
    """The encoder hands in strided per-head views of one qkv projection."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 41, 3, 3, 64)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = attention.flash_attention(q, k, v)
    want = attention.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    np.testing.assert_array_equal(got.numpy(), want.numpy())
