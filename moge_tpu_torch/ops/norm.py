"""LayerNorm with fp32 statistics (port of moge_tpu/ops/norm.py).

``layer_norm_fp32`` launches kernel K1 (``csrc/layernorm.cu``) for CUDA
tensors and runs ``layer_norm_plain`` for CPU tensors. The plain version is
the math of the JAX package's ``_ln_xla``: two-pass fp32 mean and variance,
eps inside the rsqrt, fp32 affine, one rounding to the input dtype.

Each launch follows ``ln_plan``: the ``vec16`` variant (16-byte accesses)
where D is a multiple of 16 bytes and every pointer is 16-byte aligned, else
``scalar``; the accesses per lane per row; a grid sized from the card's SM
count, each warp walking several rows.

K1 is the op ``moge::layer_norm(x, scale, bias, eps)``; its backward is the
autograd VJP of ``layer_norm_plain``, as the JAX package's ``_ln_bwd`` is
the VJP of ``_ln_xla``. Registration, routing and the launch count (kernel
``layer_norm``, variants ``vec16``/``scalar``): ``_build``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["layer_norm_fp32", "layer_norm_plain", "ln_plan", "LnPlan"]

_MAX_D = 2048  # the kernel holds a row in registers: at most 64 values per lane
WARPS = 4  # warps per block (kWarps in csrc/layernorm.cu)
BLOCKS_PER_SM = 4  # blocks of the grid per SM (kMinBlocks): 16 warps an SM
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ELEM = {torch.float32: 4, torch.bfloat16: 2}
_VARIANTS = {"vec16": 0, "scalar": 1}
# accesses per lane per row that the library is built for, by (variant, bytes per element)
# (csrc/layernorm.cu's MOGE_LN_CASE list)
VECTORS = {("vec16", 2): (1, 2, 3, 4, 6, 8), ("vec16", 4): (1, 2, 3, 4, 6, 8, 12, 16),
           ("scalar", 2): (2, 4, 8, 16, 24, 32, 48, 64), ("scalar", 4): (2, 4, 8, 16, 24, 32, 48, 64)}
K1 = _build.Entry("layer_norm", "layernorm", "moge_layer_norm",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 4
                  + [ctypes.c_void_p], variants=_VARIANTS)


class LnPlan(NamedTuple):
    """One K1 launch: its variant, the accesses per lane per row (``vectors``
    x 16 bytes for vec16, x one element for scalar), the most rows a warp
    walks, and the grid and block (threads)."""
    variant: str
    vectors: int
    rows_per_warp: int
    grid: int
    block: int


@functools.lru_cache(maxsize=1024)
def _plan(M: int, D: int, elem: int, aligned: bool, sms: int) -> LnPlan:
    if not 0 < D <= _MAX_D:
        raise ValueError(f"layer_norm_fp32 kernel takes 0 < D <= {_MAX_D}, got {D}")
    width = 16 // elem
    variant = "vec16" if aligned and D % width == 0 else "scalar"
    need = -(-D // (32 * (width if variant == "vec16" else 1)))
    vectors = next(n for n in VECTORS[variant, elem] if n >= need)
    rows_per_warp = max(1, -(-M // (sms * BLOCKS_PER_SM * WARPS)))
    warps = -(-M // rows_per_warp)
    return LnPlan(variant, vectors, rows_per_warp, -(-warps // WARPS), WARPS * 32)


def ln_plan(M: int, D: int, dtype: torch.dtype, data_ptr: int, sms: int = 132) -> LnPlan:
    """The launch of K1 over M rows of D ``dtype`` values on a card of
    ``sms`` SMs; ``data_ptr``: the bitwise or of the input's, output's,
    scale's and bias's addresses (16-byte aligned iff all are). vec16 where
    D is a multiple of 16 bytes and the pointers allow it; the fewest
    accesses per lane that hold a row; a grid of at most ``BLOCKS_PER_SM``
    blocks an SM, so that each warp walks ``rows_per_warp`` rows (strided
    by the grid's warps), or one block per ``WARPS`` rows where M is small."""
    if dtype not in _DTYPES:
        raise TypeError(f"layer_norm_fp32 kernel takes float32 or bfloat16, got {dtype}")
    return _plan(M, D, _ELEM[dtype], data_ptr % 16 == 0, sms)


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    D = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm_fp32 kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("layer_norm_fp32 kernel needs a contiguous input")
    for name, p in (("scale", scale), ("bias", bias)):
        _build.require_cuda_tensor(p, f"layer_norm_fp32 {name}")
        if p.dtype != torch.float32 or p.shape != (D,) or not p.is_contiguous() or p.device != x.device:
            raise ValueError(f"layer_norm_fp32 {name} must be a contiguous fp32 ({D},) tensor on {x.device}")
    y = torch.empty_like(x)
    M = x.numel() // max(D, 1)
    ptrs = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr())
    plan = _plan(M, D, _ELEM[x.dtype], (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % 16 == 0,
                 _build.sm_count(x.device))  # raises unless 0 < D <= 2048
    if M == 0:
        return y
    K1(plan.variant, x.device, *ptrs, M, D, eps, _DTYPES[x.dtype], _VARIANTS[plan.variant], plan.vectors,
       plan.grid)
    return y


def _fake(x, scale, bias, eps):
    return x.new_empty(x.shape)


ROUTER = _build.kernel_op("layer_norm(Tensor x, Tensor scale, Tensor bias, float eps) -> Tensor", _launch,
                          layer_norm_plain, _fake)


def layer_norm_fp32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (any leading shape) with fp32
    statistics; ``scale``/``bias`` are fp32 (D,). Output dtype = input dtype.

    CUDA tensors run kernel K1 (differentiable: backward in plain PyTorch);
    CPU tensors run ``layer_norm_plain``. Without a gradient to take, a
    traced program (``torch.export``, ``torch.compile``) records the op
    ``moge::layer_norm``."""
    return ROUTER(x, scale, bias, eps)
