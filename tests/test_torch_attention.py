"""The port's attention (moge_tpu_torch.ops.attention) against the JAX
package's ``sdpa_xla`` and its Pallas flash kernel (TPU interpret mode). On
the CPU the port runs its plain version, the oracle kernel K2 is held
against on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from moge_tpu.ops.attention import flash_attention as jax_flash, sdpa_xla
from moge_tpu_torch.ops import attention

torch.set_num_threads(1)

FP32_TOL = 1e-5          # fp32 on both sides; only the reduction order differs
FLASH_RTOL, FLASH_ATOL = 2e-3, 2e-4  # the Pallas kernel's own tolerance vs sdpa_xla (tests/test_attention.py)


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


def test_strided_qkv_views_match_contiguous():
    """The encoder hands in strided per-head views of one qkv projection."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 41, 3, 3, 64)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = attention.flash_attention(q, k, v)
    want = attention.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    np.testing.assert_array_equal(got.numpy(), want.numpy())
