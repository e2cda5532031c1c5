"""Run the MoGe-2 output heads as one batched decoder pass (port of
moge_tpu/models/multihead.py).

The points/normal/mask heads are structurally identical ConvStacks over the
same neck features. ``apply_heads_batched`` stacks their weights along a
leading group axis G and evaluates all of them at once on a (G*B, ...)
batch: every 3x3 conv is one grouped ``conv3x3_replicate`` (kernel
K3-grouped on the card; batch entry b uses head b // B), the fused
bilinear-up2 conv one grouped ``conv3x3_up2_bilinear``, and the 1x1
projections and transposed-conv resamplers per-group matmuls. Numerics are
those of the sequential ConvStack: the same ops in the same order, the
parameter algebra (folds, parity expansion) in fp32 and cast last.

Under ``torch.no_grad``/``inference_mode`` the stacked, folded and
parity-expanded weights are built once (``_weights.derived``) and reused
until a parameter changes; the JAX package rebuilds them on every call,
which is what cost it on v5e. Under autograd they are rebuilt per call, so
gradients reach every head's parameters.

Only the head family the checkpoints use is batchable (``heads_batchable``:
no norms, ReLU, resamplers in ``_SUPPORTED_RESAMPLERS``, a linear finest
level), and none under ``remat``; anything else runs the sequential path
in ``v2.py``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Sequence

import torch
import torch.nn.functional as F

from ..ops.conv import conv3x3_replicate, depth_to_space2, up2_conv3_expanded
from ..ops.resize import resize_2d
from ._weights import derived
from .modules import ConvStack, _fold_input, _fold_linear, _hwio, pixel_shuffle

__all__ = ["heads_batchable", "apply_heads_batched", "batched_heads_default"]

_SUPPORTED_RESAMPLERS = ("conv_transpose", "bilinear", "nearest", "pixel_shuffle")
# the folded finest projections are zero-padded to at least this many
# channels, as in JAX (a TPU lane width; zero columns change no output)
FOLD_PAD = 32


def batched_heads_default() -> bool:
    """``MOGE_BATCHED_HEADS`` as the JAX package reads it: off unless set to
    something other than '0', 'false' or ''."""
    return os.environ.get("MOGE_BATCHED_HEADS", "0") not in ("0", "false", "")


def heads_batchable(cfgs: Sequence[Mapping[str, Any]], remat: bool = False) -> bool:
    """True when there are at least two head configs, identical except for
    the finest ``dim_out``, using only what the batched pass implements,
    and the heads are not rematerialized (JAX ``heads_batchable`` with
    ``MOGE_BATCHED_HEADS`` on)."""
    if remat or len(cfgs) < 2:
        return False
    c0 = cfgs[0]
    n = len(c0["dim_res_blocks"])
    for c in cfgs:
        for key in ("dim_in", "dim_res_blocks", "num_res_blocks", "resamplers"):
            if list(c.get(key) or []) != list(c0.get(key) or []):
                return False
        if c.get("dim_times_res_block_hidden", 1) != c0.get("dim_times_res_block_hidden", 1):
            return False
        if c.get("res_block_in_norm", "layer_norm") != "none" or c.get("res_block_hidden_norm", "group_norm") != "none":
            return False
        if c.get("activation", "relu") != "relu":
            return False
        douts = c.get("dim_out")
        if not isinstance(douts, (list, tuple)) or len(douts) != n:
            return False
        if any(d is not None for d in douts[:-1]) or douts[-1] is None:
            return False
    if n < 2 or list(c0["num_res_blocks"])[-1] != 0:
        return False
    if any(t not in _SUPPORTED_RESAMPLERS for t in c0["resamplers"]):
        return False
    dims_in = c0["dim_in"] if isinstance(c0["dim_in"], (list, tuple)) else [c0["dim_in"]] * n
    return all(d is not None for d in dims_in)


def _stacked_weights(heads: Sequence[ConvStack], dtype: torch.dtype) -> Dict[str, Any]:
    """Every operand of the batched pass, stacked over the heads: projections
    and deconvs in ``dtype``, 3x3 kernels (G, 3, 3, C, O) in ``dtype`` with
    fp32 (G, O) biases, the finest output projections folded (padded to
    ``p_pad`` >= ``FOLD_PAD`` channels) into the last resampler's conv and
    into the finest input projection. The algebra runs in fp32; the cast
    comes last."""
    h0 = heads[0]
    n = len(h0.dim_res_blocks)
    p_pad = max(FOLD_PAD, max(h.output_blocks[n - 1].weight.shape[0] for h in heads))

    def stack(get):
        return torch.stack([get(h) for h in heads])

    def conv(get, fold=None, up2=False):
        k, b = _hwio(stack(lambda h: get(h).weight)), stack(lambda h: get(h).bias)
        if fold is not None:
            k, b = _fold_linear(k, b, *fold)
        if up2:
            return up2_conv3_expanded(k, b, dtype)
        return k.to(dtype).contiguous(), b.contiguous()

    # the finest output projections as (G, p_pad, D, 1, 1) and (G, p_pad), zero past each head's dim_out
    outs = [h.output_blocks[n - 1] for h in heads]
    wo = torch.stack([F.pad(o.weight, (0, 0, 0, 0, 0, 0, 0, p_pad - o.weight.shape[0])) for o in outs])
    bo = torch.stack([F.pad(o.bias, (0, p_pad - o.weight.shape[0])) for o in outs])
    w: Dict[str, Any] = {}
    for i in range(n - 1):
        w[f"input_{i}"] = (stack(lambda h: h.input_blocks[i].weight[:, :, 0, 0].t()).to(dtype),
                           stack(lambda h: h.input_blocks[i].bias).to(dtype))
        w[f"res_{i}"] = [(conv(lambda h: h.res_blocks[i][j].layers[2]), conv(lambda h: h.res_blocks[i][j].layers[5]))
                         for j in range(len(h0.res_blocks[i]))]
        fold = (wo, bo) if i == n - 2 else None
        t = h0.resamplers[i].type_
        if t == "conv_transpose":
            o = h0.resamplers[i][0].weight.shape[1]
            w[f"resampler_{i}"] = {
                "deconv": (stack(lambda h: h.resamplers[i][0].weight.permute(0, 2, 3, 1).reshape(-1, 4 * o)).to(dtype),
                           stack(lambda h: h.resamplers[i][0].bias).to(dtype)),
                "conv_post": conv(lambda h: h.resamplers[i][1], fold)}
        elif t == "bilinear":
            w[f"resampler_{i}"] = {"conv_post": conv(lambda h: h.resamplers[i][1], fold, up2=True)}
        elif t == "nearest":
            w[f"resampler_{i}"] = {"conv_post": conv(lambda h: h.resamplers[i][1], fold)}
        else:  # pixel_shuffle
            w[f"resampler_{i}"] = {"conv_pre": conv(lambda h: h.resamplers[i][0]),
                                   "conv_post": conv(lambda h: h.resamplers[i][2], fold)}
    wf, bf = _fold_input(stack(lambda h: h.input_blocks[n - 1].weight), stack(lambda h: h.input_blocks[n - 1].bias), wo)
    w["final"] = (wf.to(dtype), bf.to(dtype))
    return w


def apply_heads_batched(heads: Sequence[ConvStack], in_features: List[torch.Tensor],
                        dtype: torch.dtype) -> List[torch.Tensor]:
    """Evaluate G ConvStack heads over shared ``in_features`` (each (B, ...))
    in one batched pass. Returns each head's finest-level output (B, H, W,
    dim_out of that head), as ``head(in_features)[-1]`` would."""
    G = len(heads)
    h0 = heads[0]
    n = len(h0.dim_res_blocks)
    types = [r.type_ for r in h0.resamplers]
    params = [p for h in heads for p in h.parameters()]
    w = derived(h0, ("batched_heads", dtype, tuple(id(h) for h in heads)),
                lambda *_: _stacked_weights(heads, dtype), *params)
    B = in_features[0].shape[0]

    def shared_proj(feat, wb):
        """Shared (B, H, W, C) features through per-head weights -> (G*B, H, W, O)."""
        y = torch.einsum("bhwc,gco->gbhwo", feat.to(dtype), wb[0]) + wb[1][:, None, None, None, :]
        return y.reshape(G * B, *y.shape[2:])

    x = None
    for i in range(n - 1):
        z = shared_proj(in_features[i], w[f"input_{i}"])
        x = z if i == 0 else x + z
        for (k1, b1), (k2, b2) in w[f"res_{i}"]:
            h = conv3x3_replicate(x, k1, b1, input_relu=True)
            x = conv3x3_replicate(h, k2, b2, x, input_relu=True)
        r = w[f"resampler_{i}"]
        t = types[i]
        if t == "conv_transpose":
            k, b = r["deconv"]
            gb, hh, ww, c = x.shape
            o = b.shape[-1]
            y = torch.matmul(x.reshape(G, B * hh * ww, c), k).reshape(G, B, hh, ww, 2, 2, o)
            y = y.permute(0, 1, 2, 4, 3, 5, 6).reshape(G, B, 2 * hh, 2 * ww, o) + b[:, None, None, None, :]
            x = conv3x3_replicate(y.reshape(G * B, 2 * hh, 2 * ww, o), *r["conv_post"])
        elif t == "bilinear":
            x = depth_to_space2(conv3x3_replicate(x, *r["conv_post"]))
        elif t == "nearest":
            x = conv3x3_replicate(resize_2d(x, (2 * x.shape[1], 2 * x.shape[2]), mode="nearest"), *r["conv_post"])
        else:  # pixel_shuffle
            x = conv3x3_replicate(pixel_shuffle(conv3x3_replicate(x, *r["conv_pre"])), *r["conv_post"])

    # finest level: the linear epilogue, output projections already folded in
    wio, bio = w["final"]
    z = torch.einsum("bhwc,gcp->gbhwp", in_features[n - 1].to(dtype), wio) + bio[:, None, None, None, :]
    out = x.reshape(G, B, *x.shape[1:]) + z
    return [out[g][..., :h.output_blocks[n - 1].weight.shape[0]] for g, h in enumerate(heads)]
