"""Multi-head attention forward (port of moge_tpu/ops/attention.py).

``flash_attention`` launches kernel K2 (``csrc/flash_attn.cu``) for CUDA
tensors and runs ``attention_plain`` for CPU tensors. The plain version is
the math of the JAX package's ``sdpa_xla``: fp32 logits scaled by D**-0.5,
keys at or past ``kv_valid`` masked with -inf, fp32 softmax, probabilities
rounded to the value dtype before the second product.

Layout is (B, N, H, D), as in the JAX package. The kernel reads q, k and v
through their strides, so the per-head views of a (B, N, 3, H, D) qkv
projection go in without transposed copies.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "attention_plain", "LAUNCHES"]

LAUNCHES = 0  # kernel launches made by flash_attention_fwd (never by the plain version)

_HEAD_DIM = 64  # every DINOv2 arch of the repo (S/B/L/G/T) has 64-wide heads
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[int] = None, return_lse: bool = False):
    """Reference attention: (B, Nq, H, D) x (B, Nkv, H, D) -> (B, Nq, H, D)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if kv_valid is not None and kv_valid < k.shape[1]:
        keep = torch.arange(k.shape[1], device=k.device) < kv_valid
        logits = logits.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", probs.to(v.dtype).float(), v.float()).to(v.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require_cuda_tensor(t, f"flash_attention {name}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention kernel takes float32 or bfloat16 q/k/v of one dtype, "
                            f"got {q.dtype}/{k.dtype}/{v.dtype}")
        if t.dim() != 4 or t.shape[-1] != _HEAD_DIM:
            raise ValueError(f"flash_attention kernel takes (B, N, H, {_HEAD_DIM}) tensors, "
                             f"got {name} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError("flash_attention q/k/v must be on one device")
        vec = 16 // t.element_size()
        if (t.stride(-1) != 1 or t.data_ptr() % 16 != 0
                or any(s % vec for s in t.stride()[:3])):
            raise ValueError(f"flash_attention kernel needs unit-stride, 16-byte aligned rows "
                             f"({name} strides {t.stride()})")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 0 < kv_valid <= k.shape[1]:
        raise ValueError(f"kv_valid must be in [1, {k.shape[1]}], got {kv_valid}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention output (B, Nq, H, D) and per-row logsumexp (B, H, Nq) fp32.

    CUDA tensors run kernel K2; CPU tensors run ``attention_plain``."""
    global LAUNCHES
    if kv_valid is None:
        kv_valid = k.shape[1]
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_valid, return_lse=True)
    _check(q, k, v, kv_valid)
    B, Nq, H, D = q.shape
    out = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Nq), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attn")
    fn = lib.moge_flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):  # launch on the tensors' card
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                B, H, Nq, kv_valid, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                D ** -0.5, _DTYPES[q.dtype], _build.stream_ptr(q))
    _build.check(lib, rc, "flash_attention")
    LAUNCHES += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention, (B, N, H, D) layout, scale D**-0.5, fp32 softmax.

    K/V may be longer or shorter than q; keys at or past ``kv_valid``
    (default: all of them) are masked."""
    return flash_attention_fwd(q, k, v, kv_valid)[0]
