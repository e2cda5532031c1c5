"""The benchmark's plain reference of MoGe-1 and MoGe-2 inference.

Straightforward PyTorch in NCHW over a state dict of fp32 tensors (the
microsoft/MoGe checkpoint names): ``F.conv2d``, ``F.linear``, an explicit
softmax attention, ``F.layer_norm``, ``F.group_norm``, ``F.interpolate``.
It imports nothing of the program and takes nothing the program made: the
benchmark hands it the same weights and images it hands the program, and it
works out the rest again (the folded and expanded decoder weights, the
position-embedding grid, the camera solve).

``fp32`` turns TF32 off around it, so that its products run in fp32 on
the card; its controls round their operands instead (``lowp.py``).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32():
    """Matmuls and convolutions in fp32: TF32 off, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
