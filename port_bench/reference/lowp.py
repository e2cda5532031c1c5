"""The reference in a lower precision, for the controls of ``correct``.

Inside ``rounding("tf32")`` every operand of a matrix product or
convolution of the reference (activations and weights; not biases, norms,
softmax or element-wise work) is rounded to TF32's 10-bit mantissa before
an fp32 product (round to nearest, as the tensor cores take fp32 inputs).
Emulated, so the control runs alike on the card and on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_MODE: Optional[str] = None


@contextlib.contextmanager
def rounding(mode: Optional[str]):
    global _MODE
    saved, _MODE = _MODE, mode
    try:
        yield
    finally:
        _MODE = saved


def operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the active mode (unchanged outside ``rounding``)."""
    if _MODE is None:
        return t
    if _MODE == "tf32":
        bits = t.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    raise ValueError(f"unknown rounding {_MODE!r}")
