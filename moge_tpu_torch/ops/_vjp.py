"""Backward of a kernel-backed op as the autograd VJP of its plain version.

K1 and K3 have no backward kernel (nor do their TPU counterparts, whose VJPs
are XLA formulations): their autograd Functions recompute the plain version
under autograd in the backward and pull the cotangent through it.
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
