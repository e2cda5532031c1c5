"""W8A8 dynamic int8 quantization of the encoder's linear layers (port of
moge_tpu/ops/quant.py).

    y = (round(x / s_a) @ round(W / s_w)) * s_a * s_w + b      (int32 accumulate)

Weights are quantized symmetrically per output channel and activations per
row (per token) on every call; a scale is max|.| / 127, or 1 where the
max is 0. Rounding is half to even, as in the JAX package, so the int8
operands, the int32 accumulators and the fp32 result follow its
arithmetic step for step.

``int8_product`` is the int8 x int8 -> int32 product. On a CUDA tensor it is
``torch._int_mm`` (cuBLASLt on the int8 tensor cores), whose shape rules
(more than 16 rows, K and N multiples of 8) it checks and raises on; it
never falls back to a floating-point product. On a CPU tensor it is the
plain version: an fp64 product, exact for every int8 operand of K < 2**38
terms (|sum| < 2**53). The JAX package computes this product with XLA
outside any Pallas kernel: it is not one of the ported TPU kernels, and
its card calls are counted (kernel ``int8_product`` in ``_build``'s launch
count) only to show that a path took it.

``QuantLinear`` is an ``nn.Linear`` twin (same parameter names, fp32) whose
forward is ``quant_matmul``; the quantized weight and its scales are
derived once per weight (``models/_weights.derived``), which equals the
JAX package's per-call quantization, since it is deterministic.

Not the parity path: against bf16 the outputs drift by about 1e-2
relative. It is selected by ``MoGeModel(..., use_int8=True)`` and
``serve --int8``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..models._weights import derived
from . import _build

__all__ = ["quantize", "int8_product", "quant_matmul", "QuantLinear"]

_build.declare("int8_product")


def quantize(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of each row of ``t`` (over its last axis):
    (int8 values, fp32 scales with a trailing axis of 1)."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1, keepdim=True)
    # divided by a tensor: PyTorch's CUDA division by a Python number multiplies by
    # its reciprocal, which can put a scale one ulp off the true quotient
    scale = torch.where(amax > 0, amax / amax.new_full((), 127.0), torch.ones_like(amax))
    return torch.round(tf / scale).to(torch.int8), scale


def int8_product(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K) int8 transposed -> (M, N) int32."""
    if x_q.device.type == "cpu":
        return (x_q.double() @ w_q.double().T).to(torch.int32)
    (m, k), n = x_q.shape, w_q.shape[0]
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f"the int8 product on the card needs more than 16 rows and K, N multiples of 8; "
                         f"got ({m}, {k}) @ ({k}, {n})")
    acc = torch._int_mm(x_q, w_q.T)
    _build.count("int8_product")
    return acc


def quant_matmul(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 w_quant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` ((..., K) by an (N, K) weight) with
    dynamic W8A8 quantization, in fp32. ``w_quant``: ``quantize(weight)``,
    when the caller holds it already."""
    w_q, w_scale = quantize(weight) if w_quant is None else w_quant
    x_q, a_scale = quantize(x.reshape(-1, x.shape[-1]))
    y = int8_product(x_q, w_q).float() * a_scale * w_scale.reshape(-1)
    if bias is not None:
        y = y + bias.float()
    return y.reshape(*x.shape[:-1], -1)


class QuantLinear(nn.Linear):
    """nn.Linear (fp32 parameters) computing W8A8 int8; the output has the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_quant = derived(self, "int8", quantize, self.weight)
        return quant_matmul(x, self.weight, self.bias, w_quant).to(x.dtype)
