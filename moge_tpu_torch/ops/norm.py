"""LayerNorm with fp32 statistics (port of moge_tpu/ops/norm.py).

``layer_norm_fp32`` launches kernel K1 (``csrc/layernorm.cu``) for CUDA
tensors and runs ``layer_norm_plain`` for CPU tensors. The plain version is
the math of the JAX package's ``_ln_xla``: two-pass fp32 mean and variance,
eps inside the rsqrt, fp32 affine, one rounding to the input dtype.

Each launch follows ``ln_plan``: the ``vec16`` variant (16-byte accesses)
where D is a multiple of 16 bytes and every pointer is 16-byte aligned, else
``scalar``; the accesses per lane per row; a grid sized from the card's SM
count, each warp walking several rows. Each launch is also counted under its
variant in ``VARIANT_LAUNCHES``.

K1 is also the dispatcher op ``moge::layer_norm(x, scale, bias, eps)``,
registered when this module is imported: its CUDA implementation is the
launch (``_launch``: the plan, the ctypes call, the counts, the error
check, all at run time), its CPU implementation the plain version, and its
fake implementation gives the output's shape, so ``torch.export`` records
the op as one node and an exported program launches K1 when it runs.

On the card K1 sits in an autograd Function whose backward is the autograd
VJP of ``layer_norm_plain``, as the JAX package's ``_ln_bwd`` is the VJP of
``_ln_xla``: the TPU has no backward kernel for it either. Where no
gradient is needed ``layer_norm_fp32`` calls the op while a program is
traced and the launch directly otherwise: the dispatcher's hop costs host
time on every call (PERF.md).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from ._vjp import plain_vjp

__all__ = ["layer_norm_fp32", "layer_norm_plain", "ln_plan", "LnPlan", "LAUNCHES", "VARIANT_LAUNCHES"]

LAUNCHES = 0  # kernel launches made by layer_norm_fp32 (never by the plain version)
VARIANT_LAUNCHES = {"vec16": 0, "scalar": 0}  # every K1 launch, counted once more under its variant

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
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 4
             + [ctypes.c_void_p])


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


@functools.lru_cache(maxsize=None)
def _kernel():
    """The library and its entry point, typed once."""
    lib = _build.load("layernorm")
    fn = lib.moge_layer_norm
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    global LAUNCHES
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
    lib, fn = _kernel()
    rc = _build.call_on(x.device, fn, *ptrs, M, D, eps, _DTYPES[x.dtype], _VARIANTS[plan.variant], plan.vectors,
                        plan.grid)
    _build.check(lib, rc, "layer_norm_fp32")
    LAUNCHES += 1
    VARIANT_LAUNCHES[plan.variant] += 1
    return y


def _plain_op(x, scale, bias, eps):
    return layer_norm_plain(x, scale, bias, eps).contiguous()


def _fake(x, scale, bias, eps):
    return x.new_empty(x.shape)


_build.define_op("layer_norm(Tensor x, Tensor scale, Tensor bias, float eps) -> Tensor", _launch, _plain_op, _fake)


class _LayerNorm(torch.autograd.Function):
    """K1 forward; backward = VJP of ``layer_norm_plain`` (grads to x, scale, bias)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _launch(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(layer_norm_plain, ctx.saved_tensors, ctx.needs_input_grad, g, ctx.eps), None)


def layer_norm_fp32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (any leading shape) with fp32
    statistics; ``scale``/``bias`` are fp32 (D,). Output dtype = input dtype.

    CUDA tensors run kernel K1 (differentiable: backward in plain PyTorch);
    CPU tensors run ``layer_norm_plain``. Without a gradient to take, a
    traced program (``torch.export``, ``torch.compile``) records the op
    ``moge::layer_norm``."""
    grad = _build.needs_grad(x, scale, bias)
    if not grad and torch.compiler.is_compiling():
        return torch.ops.moge.layer_norm(x, scale, bias, eps)
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    _build.require_cuda_tensor(x, "layer_norm_fp32")
    if not grad:
        return _launch(x, scale, bias, eps)
    return _LayerNorm.apply(x, scale, bias, eps)
