"""Serialized deployment artifacts through ``torch.export`` (port of
moge_tpu/models/export.py).

The JAX package exports a model as a StableHLO program with its weights
embedded as constants; the port's counterpart is a ``torch.export``
program, saved to bytes with ``torch.export.save``. It is self-contained
and fixed-shape: one (batch, height, width, num_tokens) signature per
export, weights and derived weights held as program constants. Two forms,
as in the JAX package:

- the raw forward (``make_raw_forward_fn``): ``MoGeV2.forward`` /
  ``MoGeV1.forward``, fp32 by default;
- the whole MoGe-2 ``infer`` (``make_infer_fn``, ``with_postprocess``):
  the resize to the token grid, ``MoGeV2.decode``, ``apply_epilogue`` and
  ``postprocess``, so the 30-iteration focal/shift solve runs inside the
  artifact; bf16 by default.

An artifact is targeted at the device it was exported on. The kernels
enter the graph as the dispatcher ops ``moge::layer_norm``,
``moge::flash_attention`` and ``moge::conv3x3``: a CUDA artifact launches
K1, K2 and K3 through them, a CPU one runs their plain versions. Loading
needs ``moge_tpu_torch`` importable, which registers the ops.

The derived weights (bf16 casts, folded and parity-expanded convs, the
batched heads' stacks, the interpolated pos-embed) become constants
computed once: ``export_program`` fills the model's derived-weight cache by
one eager call of the same shapes under ``torch.no_grad()`` and traces
after it, with the model held outside the traced module, so every tensor
the trace reads from it is lifted as a constant and none is recomputed
per call.

    python -m moge_tpu_torch.scripts.cli export_program --pretrained model.pt -o model.pt2 \\
        --height 518 --width 518 --num_tokens 1800 --with_postprocess
"""

from __future__ import annotations

import io
from typing import Callable, Dict, Optional

import torch
from torch import nn

from .. import ops  # noqa: F401  (registers the torch.ops.moge ops an artifact calls)
from ..ops.resize import resize_2d
from ._weights import drop_derived

__all__ = ["make_raw_forward_fn", "make_infer_fn", "export_program", "load_program"]

Program = Callable[[torch.Tensor], Dict[str, torch.Tensor]]


def make_raw_forward_fn(model, num_tokens: int, use_fp16: bool = False) -> Program:
    """image (B, H, W, 3) fp32 in [0, 1] -> the model's raw forward outputs
    (MoGe-2: points, normal, mask_logit, mask, metric_scale, whichever heads
    exist; MoGe-1: points and the raw mask), computed in the model's dtype
    with ``use_fp16``, else fp32."""
    module = model.module
    dtype = model.dtype if use_fp16 else torch.float32

    def fn(image: torch.Tensor) -> Dict[str, torch.Tensor]:
        return module(image, num_tokens, dtype)

    return fn


def make_infer_fn(model, height: int, width: int, num_tokens: int, use_fp16: bool = True,
                  force_projection: bool = True, apply_mask: bool = True) -> Program:
    """image (B, height, width, 3) fp32 -> the whole ``infer`` output dict
    (points, depth, mask, intrinsics, normal; the metric scale folded into
    points and depth), camera recovery included: the pieces
    ``MoGeModel.infer`` runs, in its order. MoGe-2 only."""
    from .v2 import MoGeModel, apply_epilogue, base_token_grid, postprocess

    if not isinstance(model, MoGeModel):
        raise ValueError("--with_postprocess export requires a MoGe-2 model")
    aspect = width / height
    base_h, base_w = base_token_grid(num_tokens, aspect)
    dtype = model.dtype if use_fp16 else torch.float32
    module = model.module

    def fn(image: torch.Tensor) -> Dict[str, torch.Tensor]:
        image_14 = resize_2d(image, (base_h * 14, base_w * 14), mode="bilinear", antialias=True)
        raw = module.decode(image_14, base_h, base_w, aspect, dtype)
        full = apply_epilogue(raw, height, width, module.remap_output)
        return postprocess(full, aspect, None, force_projection, apply_mask)

    return fn


class _Program(nn.Module):
    """The traced root: ``fn`` holds the model, which is no submodule, so
    ``torch.export`` lifts what it reads as constants, not parameters."""

    def __init__(self, fn: Program):
        super().__init__()
        self.fn = fn

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.fn(image)


def export_program(model, height: int, width: int, num_tokens: int, batch: int = 1,
                   with_postprocess: bool = False, use_fp16: Optional[bool] = None) -> bytes:
    """One inference program for a (batch, height, width, 3) fp32 image on
    the model's device, as the bytes of ``torch.export.save``. Defaults: the
    raw forward in fp32; with ``with_postprocess`` the whole ``infer`` in
    the model's dtype (bf16)."""
    if with_postprocess:
        fn = make_infer_fn(model, height, width, num_tokens, use_fp16=True if use_fp16 is None else use_fp16)
    else:
        fn = make_raw_forward_fn(model, num_tokens, use_fp16=False if use_fp16 is None else use_fp16)
    image = torch.zeros((batch, height, width, 3), dtype=torch.float32, device=model.device)
    drop_derived(model.module)  # entries made under inference mode would be inference tensors
    trainable = [p for p in model.module.parameters() if p.requires_grad]
    buf = io.BytesIO()
    try:
        for p in trainable:  # the program's constants (these tensors themselves) take no gradient
            p.requires_grad_(False)
        with torch.no_grad():
            fn(image)  # fills the derived-weight cache the trace reads
            torch.export.save(torch.export.export(_Program(fn), (image,), strict=False), buf)
    finally:
        for p in trainable:
            p.requires_grad_(True)
    return buf.getvalue()


def load_program(blob: bytes) -> Program:
    """The program saved by ``export_program``, as a callable: image (B, H,
    W, 3) fp32 on the device it was exported on -> the output dict."""
    return torch.export.load(io.BytesIO(blob)).module()
