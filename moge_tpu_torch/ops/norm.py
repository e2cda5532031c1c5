"""LayerNorm with fp32 statistics (port of moge_tpu/ops/norm.py).

``layer_norm_fp32`` launches kernel K1 (``csrc/layernorm.cu``) for CUDA
tensors and runs ``layer_norm_plain`` for CPU tensors. The plain version is
the math of the JAX package's ``_ln_xla``: two-pass fp32 mean and variance,
eps inside the rsqrt, fp32 affine, one rounding to the input dtype.

On the card K1 sits in an autograd Function whose backward is the autograd
VJP of ``layer_norm_plain``, as the JAX package's ``_ln_bwd`` is the VJP of
``_ln_xla``: the TPU has no backward kernel for it either.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._vjp import plain_vjp

__all__ = ["layer_norm_fp32", "layer_norm_plain", "LAUNCHES"]

LAUNCHES = 0  # kernel launches made by layer_norm_fp32 (never by the plain version)

_MAX_D = 2048  # the kernel holds a row in registers: at most 64 values per lane
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int]
             + [ctypes.c_void_p])


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    global LAUNCHES
    D = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm_fp32 kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("layer_norm_fp32 kernel needs a contiguous input")
    if not 0 < D <= _MAX_D:
        raise ValueError(f"layer_norm_fp32 kernel takes 0 < D <= {_MAX_D}, got {D}")
    for name, p in (("scale", scale), ("bias", bias)):
        _build.require_cuda_tensor(p, f"layer_norm_fp32 {name}")
        if p.dtype != torch.float32 or p.shape != (D,) or not p.is_contiguous() or p.device != x.device:
            raise ValueError(f"layer_norm_fp32 {name} must be a contiguous fp32 ({D},) tensor on {x.device}")
    y = torch.empty_like(x)
    M = x.numel() // D
    if M == 0:
        return y
    lib = _build.load("layernorm")
    fn = lib.moge_layer_norm
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):  # launch on the tensors' card
        rc = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), M, D, eps,
                _DTYPES[x.dtype], _build.stream_ptr(x))
    _build.check(lib, rc, "layer_norm_fp32")
    LAUNCHES += 1
    return y


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
    CPU tensors run ``layer_norm_plain``."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    _build.require_cuda_tensor(x, "layer_norm_fp32")
    return _LayerNorm.apply(x, scale, bias, eps)
