"""MoGe-2 and MoGe-1 forward and ``infer`` as published, over a state dict.

``param_specs`` lists every tensor of the checkpoint layout with its shape,
so that the benchmark can draw the weights; ``infer`` maps (B, H, W, 3)
images in [0, 1] to the program's outputs (points, depth, intrinsics, mask,
and normal for MoGe-2). Every step is in fp32
(the products' operands rounded under ``lowp.rounding``), NCHW inside.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import camera, vit
from .lowp import operand

SD = Dict[str, torch.Tensor]


# -- layout -------------------------------------------------------------------

def _conv(p: str, o: int, i: int, k: int) -> List[Tuple[str, tuple]]:
    return [(p + "weight", (o, i, k, k)), (p + "bias", (o,))]


def _vit_specs(p: str, arch: str) -> List[Tuple[str, tuple]]:
    dim, depth, _, ffn = vit.ARCHS[arch]
    hidden = vit.ffn_hidden(arch)
    first, second = ("mlp.w12.", "mlp.w3.") if ffn == "swiglu" else ("mlp.fc1.", "mlp.fc2.")
    width = 2 * hidden if ffn == "swiglu" else hidden  # the fused SwiGLU's first linear gives x1 and x2
    out = [(p + "cls_token", (1, 1, dim)), (p + "pos_embed", (1, vit.POS_GRID ** 2 + 1, dim)),
           (p + "mask_token", (1, dim)), *_conv(p + "patch_embed.proj.", dim, 3, vit.PATCH)]
    for i in range(depth):
        b = f"{p}blocks.{i}."
        out += [(b + "norm1.weight", (dim,)), (b + "norm1.bias", (dim,)),
                (b + "attn.qkv.weight", (3 * dim, dim)), (b + "attn.qkv.bias", (3 * dim,)),
                (b + "attn.proj.weight", (dim, dim)), (b + "attn.proj.bias", (dim,)), (b + "ls1.gamma", (dim,)),
                (b + "norm2.weight", (dim,)), (b + "norm2.bias", (dim,)),
                (b + first + "weight", (width, dim)), (b + first + "bias", (width,)),
                (b + second + "weight", (dim, hidden)), (b + second + "bias", (dim,)), (b + "ls2.gamma", (dim,))]
    return out + [(p + "norm.weight", (dim,)), (p + "norm.bias", (dim,))]


def _listify(v, n):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def _stack_cfg(cfg: Dict[str, Any]):
    n = len(cfg["dim_res_blocks"])
    return (n, _listify(cfg["dim_in"], n), _listify(cfg["dim_out"], n), _listify(cfg.get("num_res_blocks", 1), n),
            _listify(cfg["resamplers"], n - 1))


def _norm_specs(p: str, kind: str, c: int):
    return [(p + "weight", (c,)), (p + "bias", (c,))] if kind in ("group_norm", "layer_norm") else []


def _res_specs(p: str, c_in: int, c_out: int, hidden: int, in_norm: str, hidden_norm: str):
    out = _norm_specs(p + "layers.0.", in_norm, c_in) + _conv(p + "layers.2.", hidden, c_in, 3)
    out += _norm_specs(p + "layers.3.", hidden_norm, hidden) + _conv(p + "layers.5.", c_out, hidden, 3)
    return out + (_conv(p + "skip_connection.", c_out, c_in, 1) if c_in != c_out else [])


def _convstack_specs(p: str, cfg: Dict[str, Any]):
    n, dims_in, dims_out, counts, types = _stack_cfg(cfg)
    d = cfg["dim_res_blocks"]
    hidden = cfg.get("dim_times_res_block_hidden", 1)
    out = []
    for i in range(n):
        if dims_in[i] is not None:
            out += _conv(f"{p}input_blocks.{i}.", d[i], dims_in[i], 1)
    for i in range(n):
        for j in range(counts[i]):
            out += _res_specs(f"{p}res_blocks.{i}.{j}.", d[i], d[i], hidden * d[i],
                              cfg.get("res_block_in_norm", "layer_norm"), cfg.get("res_block_hidden_norm", "group_norm"))
    for i in range(n - 1):
        r = f"{p}resamplers.{i}."
        if types[i] == "conv_transpose":
            out += [(r + "0.weight", (d[i], d[i + 1], 2, 2)), (r + "0.bias", (d[i + 1],))] + _conv(r + "1.", d[i + 1], d[i + 1], 3)
        elif types[i] == "bilinear":
            out += _conv(r + "1.", d[i + 1], d[i], 3)
        else:
            raise ValueError(f"resampler {types[i]!r} is not in the benchmark's reference")
    for i in range(n):
        if dims_out[i] is not None:
            out += _conv(f"{p}output_blocks.{i}.", dims_out[i], d[i], 1)
    return out


_HEADS = ("points_head", "normal_head", "mask_head")


def param_specs(version: str, cfg: Dict[str, Any]) -> List[Tuple[str, tuple]]:
    """Every tensor of the checkpoint's state dict, in order, with its shape."""
    if version == "v2":
        enc = cfg["encoder"]
        dim = vit.ARCHS[enc["backbone"]][0]
        out = [("encoder.image_mean", (1, 3, 1, 1)), ("encoder.image_std", (1, 3, 1, 1))]
        out += _vit_specs("encoder.backbone.", enc["backbone"])
        for i in range(len(enc["intermediate_layers"])):
            out += _conv(f"encoder.output_projections.{i}.", enc["dim_out"], dim, 1)
        out += _convstack_specs("neck.", cfg["neck"])
        for name in _HEADS:
            if cfg.get(name) is not None:
                out += _convstack_specs(name + ".", cfg[name])
        dims = cfg["scale_head"]["dims"]
        for k, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out += [(f"scale_head.{2 * k}.weight", (b, a)), (f"scale_head.{2 * k}.bias", (b,))]
        return out
    dim = vit.ARCHS[cfg["encoder"]][0]
    out = [("image_mean", (1, 3, 1, 1)), ("image_std", (1, 3, 1, 1))] + _vit_specs("backbone.", cfg["encoder"])
    proj, ups = cfg["dim_proj"], list(cfg["dim_upsample"])
    hidden = cfg["dim_times_res_block_hidden"]
    for i in range(_num_taken(cfg)):
        out += _conv(f"head.projects.{i}.", proj, dim, 1)
    for s, (a, b) in enumerate(zip([proj] + ups[:-1], ups)):
        p = f"head.upsample_blocks.{s}."
        out += [(p + "0.0.weight", (a + 2, b, 2, 2)), (p + "0.0.bias", (b,))] + _conv(p + "0.1.", b, b, 3)
        for j in range(cfg["num_res_blocks"]):
            out += _res_specs(f"{p}{1 + j}.", b, b, hidden * b, "layer_norm", cfg["res_block_norm"])
    for o, d_out in enumerate((3, 1)):
        p = f"head.output_block.{o}."
        c = cfg["last_conv_channels"]
        out += _conv(p + "0.", c, ups[-1] + 2, 3)
        for j in range(cfg["last_res_blocks"]):
            out += _res_specs(f"{p}{1 + j}.", c, c, hidden * c, "layer_norm", cfg["res_block_norm"])
        out += _conv(f"{p}{2 + cfg['last_res_blocks']}.", d_out, c, cfg["last_conv_size"])
    return out


def _num_taken(cfg) -> int:
    layers = cfg["intermediate_layers"]
    return layers if isinstance(layers, int) else len(layers)


# -- building blocks (NCHW) ---------------------------------------------------------

def convk(sd: SD, p: str, x: torch.Tensor) -> torch.Tensor:
    """A replicate-pad k x k convolution (k odd)."""
    k = sd[p + "weight"].shape[-1]
    x = F.pad(x, (k // 2,) * 4, mode="replicate") if k > 1 else x
    return F.conv2d(operand(x), operand(sd[p + "weight"]), sd[p + "bias"])


conv3x3 = conv1x1 = convk


def conv_transpose2x(sd: SD, p: str, x: torch.Tensor) -> torch.Tensor:
    return F.conv_transpose2d(operand(x), operand(sd[p + "weight"]), sd[p + "bias"], stride=2)


def norm2d(sd: SD, p: str, kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "none":
        return x
    if kind == "instance_norm":
        return F.instance_norm(x, eps=1e-5)
    groups = x.shape[1] // 32 if kind == "group_norm" else 1
    return F.group_norm(x, groups, sd[p + "weight"], sd[p + "bias"], 1e-5)


def res_block(sd: SD, p: str, x: torch.Tensor, in_norm: str, hidden_norm: str) -> torch.Tensor:
    skip = conv1x1(sd, p + "skip_connection.", x) if p + "skip_connection.weight" in sd else x
    h = conv3x3(sd, p + "layers.2.", F.relu(norm2d(sd, p + "layers.0.", in_norm, x)))
    h = conv3x3(sd, p + "layers.5.", F.relu(norm2d(sd, p + "layers.3.", hidden_norm, h)))
    return h + skip


def conv_stack(sd: SD, p: str, cfg: Dict[str, Any], features: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
    n, dims_in, dims_out, counts, types = _stack_cfg(cfg)
    outs, x = [], None
    for i in range(n):
        f = features[i] if i < len(features) else None
        if f is not None and dims_in[i] is not None:
            f = conv1x1(sd, f"{p}input_blocks.{i}.", f)
        x = f if i == 0 else (x + f if f is not None else x)
        for j in range(counts[i]):
            x = res_block(sd, f"{p}res_blocks.{i}.{j}.", x, cfg.get("res_block_in_norm", "layer_norm"),
                          cfg.get("res_block_hidden_norm", "group_norm"))
        outs.append(conv1x1(sd, f"{p}output_blocks.{i}.", x) if dims_out[i] is not None else x)
        if i < n - 1:
            r = f"{p}resamplers.{i}."
            if types[i] == "conv_transpose":
                x = conv_transpose2x(sd, r + "0.", x)
            else:
                x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
            x = conv3x3(sd, r + "1.", x)
    return outs


def _uv(batch: int, h: int, w: int, aspect_ratio: float, device) -> torch.Tensor:
    """(B, 2, h, w) view-plane UV of a level of the pyramid."""
    return camera.view_plane_uv(w, h, aspect_ratio, device).permute(2, 0, 1)[None].expand(batch, 2, h, w)


def _resize(x: torch.Tensor, size, mode="bilinear", antialias=False) -> torch.Tensor:
    return F.interpolate(x, size=size, mode=mode, align_corners=False, antialias=antialias)


def token_grid(num_tokens: int, aspect_ratio: float) -> Tuple[int, int]:
    return round((num_tokens / aspect_ratio) ** 0.5), round((num_tokens * aspect_ratio) ** 0.5)


def num_tokens_of(cfg: Dict[str, Any], resolution_level: int) -> int:
    lo, hi = cfg["num_tokens_range"]
    return int(lo + (resolution_level / 9) * (hi - lo))


# -- MoGe-2 ------------------------------------------------------------------

def v2_infer(sd: SD, cfg: Dict[str, Any], image: torch.Tensor, num_tokens: int,
             fov_x: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """``image`` (B, H, W, 3) in [0, 1] -> the outputs of MoGe-2's ``infer``."""
    b, h, w, _ = image.shape
    ar = w / h
    gh, gw = token_grid(num_tokens, ar)
    x = vit.normalize(_resize(image.permute(0, 3, 1, 2).float(), (gh * 14, gw * 14), antialias=True))
    enc = cfg["encoder"]
    feats = vit.forward(sd, "encoder.backbone.", enc["backbone"], x, enc["intermediate_layers"])
    f = None
    for i, (tokens, _) in enumerate(feats):
        y = conv1x1(sd, f"encoder.output_projections.{i}.", tokens.transpose(1, 2).reshape(b, -1, gh, gw))
        f = y if f is None else f + y
    uvs = [_uv(b, gh * 2 ** l, gw * 2 ** l, ar, image.device) for l in range(5)]
    neck = conv_stack(sd, "neck.", cfg["neck"], [torch.cat([f, uvs[0]], 1), *uvs[1:]])
    raw = {name: conv_stack(sd, name + ".", cfg[name], neck)[-1] for name in _HEADS if cfg.get(name) is not None}
    s = feats[-1][1]
    dims = cfg["scale_head"]["dims"]
    for k in range(len(dims) - 1):
        s = vit.linear(s if k == 0 else F.relu(s), sd[f"scale_head.{2 * k}.weight"], sd[f"scale_head.{2 * k}.bias"])
    metric_scale = torch.exp(s[:, 0])

    pts = _resize(raw["points_head"], (h, w)).permute(0, 2, 3, 1)
    assert cfg["remap_output"] == "exp"
    z = torch.exp(pts[..., 2:])
    pts = torch.cat([pts[..., :2] * z, z], -1)
    normal = None
    if "normal_head" in raw:
        normal = F.normalize(_resize(raw["normal_head"], (h, w)), dim=1, eps=1e-12).permute(0, 2, 3, 1)
    mask = torch.sigmoid(_resize(raw["mask_head"], (h, w))[:, 0]) > 0.5
    return camera.postprocess(pts, mask, ar, normal, metric_scale, fov_x)


# -- MoGe-1 ------------------------------------------------------------------

def v1_infer(sd: SD, cfg: Dict[str, Any], image: torch.Tensor, num_tokens: int,
             fov_x: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """``image`` (B, H, W, 3) in [0, 1] -> the outputs of MoGe-1's ``infer``."""
    b, h, w, _ = image.shape
    ar = w / h
    factor = ((num_tokens * 14 ** 2) / (h * w)) ** 0.5
    rh, rw = int(h * factor), int(w * factor)
    x = vit.normalize(_resize(image.permute(0, 3, 1, 2).float(), (rh, rw), mode="bicubic", antialias=True))
    ph, pw = rh // 14, rw // 14
    x = _resize(x, (ph * 14, pw * 14), antialias=True)
    layers = cfg["intermediate_layers"]
    depth = vit.ARCHS[cfg["encoder"]][1]
    take = list(range(depth - layers, depth)) if isinstance(layers, int) else list(layers)
    feats = vit.forward(sd, "backbone.", cfg["encoder"], x, take)
    y = None
    for i, (tokens, _) in enumerate(feats):
        t = conv1x1(sd, f"head.projects.{i}.", tokens.transpose(1, 2).reshape(b, -1, ph, pw))
        y = t if y is None else y + t
    head_ar = rw / rh  # the head's view-plane UV follows the resized image
    for s in range(len(cfg["dim_upsample"])):
        p = f"head.upsample_blocks.{s}."
        y = torch.cat([y, _uv(b, y.shape[2], y.shape[3], head_ar, image.device)], 1)
        y = conv3x3(sd, p + "0.1.", conv_transpose2x(sd, p + "0.0.", y))
        for j in range(cfg["num_res_blocks"]):
            y = res_block(sd, f"{p}{1 + j}.", y, "layer_norm", cfg["res_block_norm"])
    y = _resize(y, (rh, rw))
    y = torch.cat([y, _uv(b, rh, rw, head_ar, image.device)], 1)
    outs = []
    for o in range(2):
        p = f"head.output_block.{o}."
        t = conv3x3(sd, p + "0.", y)
        for j in range(cfg["last_res_blocks"]):
            t = res_block(sd, f"{p}{1 + j}.", t, "layer_norm", cfg["res_block_norm"])
        outs.append(convk(sd, f"{p}{2 + cfg['last_res_blocks']}.", F.relu(t)))
    pts = _resize(outs[0], (h, w)).permute(0, 2, 3, 1)
    assert cfg["remap_output"] == "exp"
    z = torch.exp(pts[..., 2:])
    pts = torch.cat([pts[..., :2] * z, z], -1)
    mask = _resize(outs[1], (h, w))[:, 0] > cfg.get("mask_threshold", 0.5)
    return camera.postprocess(pts, mask, ar, fov_x=fov_x, positive_depth=False)


def infer(version: str, sd: SD, cfg: Dict[str, Any], image: torch.Tensor, num_tokens: int,
          fov_x: Optional[float] = None) -> Dict[str, torch.Tensor]:
    return (v2_infer if version == "v2" else v1_infer)(sd, cfg, image, num_tokens, fov_x)
