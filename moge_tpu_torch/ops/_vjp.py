"""Backward of a kernel-backed op as the autograd VJP of its plain version.

K1 and K3 have no backward kernel (nor do their TPU counterparts, whose VJPs
are XLA formulations): their gradient route, ``PlainVJP``, runs the kernel
forward and in the backward recomputes the plain version under autograd
and pulls the cotangent through it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def plain_vjp(fn: Callable, inputs: Sequence[Optional[torch.Tensor]], needs: Sequence[bool],
              g: torch.Tensor, *args) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of ``fn(*inputs, *args)`` for cotangent ``g`` w.r.t. each
    input whose ``needs`` flag is set (None elsewhere and for None inputs)."""
    leaves = [None if t is None else t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
    wrt = [t for t in leaves if t is not None and t.requires_grad]
    with torch.enable_grad():
        grads = iter(torch.autograd.grad(fn(*leaves, *args), wrt, g) if wrt else ())
    return tuple(next(grads) if t is not None and t.requires_grad else None for t in leaves)


class PlainVJP(torch.autograd.Function):
    """``PlainVJP.apply(launch, plain, *args)``: ``launch(*args)`` forward;
    backward the VJP of ``plain(*args)`` with respect to the leading
    tensor (or None) arguments; the arguments after them pass through."""

    @staticmethod
    def forward(ctx, launch: Callable, plain: Callable, *args):
        n = next((i for i, a in enumerate(args) if a is not None and not isinstance(a, torch.Tensor)), len(args))
        ctx.save_for_backward(*args[:n])
        ctx.plain, ctx.rest = plain, args[n:]
        return launch(*args)

    @staticmethod
    def backward(ctx, g):
        grads = plain_vjp(ctx.plain, ctx.saved_tensors, ctx.needs_input_grad[2:], g, *ctx.rest)
        return (None, None, *grads, *(None,) * len(ctx.rest))
