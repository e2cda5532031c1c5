"""Seeded weights and images, made on the device in a few large calls.

``draw`` fills one flat fp32 buffer with the distributions the program's
own random init uses (lecun-normal kernels truncated at two deviations,
zero biases and tokens, position embedding N(0, 0.02), LayerScale and norm
scales one) and returns the checkpoint-layout state dict as views into it.
Random weights give point maps with no perspective in them: the camera
solve on such a map turns rounding-level changes into any focal, so no
comparison after the solve would mean anything. ``draw`` therefore routes
the view-plane UV that the decoder is given into the point map's output,
(u, v, z + tilt u) / focal for x and y, and keeps the random network on
top of it at the small scale ``eps``: the solve then has one answer, and
every layer of the network still moves every output. The mask logits are
raised by ``mask_logit`` so that most pixels stay valid.

Trained ViTs carry a few LayerNorm channels far larger than the rest (the
outlier features of LLM.int8(), Dettmers et al. 2022; the massive
activations of Sun et al. 2024), and random weights carry none, so they
hide what a per-token int8 activation loses. ``draw`` gives each ViT
block's two LayerNorms ``outliers["channels"]`` seeded channels
``outliers["gain"]`` times as large and divides the next linear's weights
for those inputs by the same factor: a power of two, so the network's
function is unchanged bit for bit in every floating-point precision, and
only a fixed-point activation sees the larger range.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict

import torch

from .reference import models, vit


def _kind(name: str, shape: tuple) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "pos_embed":
        return "pos"
    if leaf in ("bias", "cls_token", "mask_token"):
        return "zero"
    if leaf == "gamma" or (leaf == "weight" and len(shape) == 1):
        return "one"
    if leaf in ("image_mean", "image_std"):
        return leaf
    return "lecun"


def _fan_in(shape: tuple) -> int:
    numel = 1
    for s in shape:
        numel *= s
    # a 2x2 transposed conv's weight is (in, out, 2, 2)
    return numel // (shape[1] if len(shape) == 4 and shape[2:] == (2, 2) else shape[0])


def draw(version: str, cfg: Dict[str, Any], geometry: Dict[str, float], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """The state dict for ``seed``: views into one flat buffer."""
    specs = models.param_specs(version, cfg)
    sizes = [torch.Size(shape).numel() for _, shape in specs]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    sd, offset = {}, 0
    with torch.no_grad():
        for (name, shape), size in zip(specs, sizes):
            t = flat[offset:offset + size].view(shape)
            offset += size
            kind = _kind(name, shape)
            if kind == "pos":
                t.normal_(0.0, 0.02, generator=gen)
            elif kind == "zero":
                t.zero_()
            elif kind == "one":
                t.fill_(1.0)
            elif kind in ("image_mean", "image_std"):
                t.copy_(torch.tensor(vit.IMAGENET_MEAN if kind == "image_mean" else vit.IMAGENET_STD).view(shape))
            else:
                t.mul_((1.0 / _fan_in(shape)) ** 0.5 / 0.87962566103423978)
            sd[name] = t
        geometry = dict(geometry)
        _outliers(sd, **geometry.pop("outliers"), gen=gen)
        (_perspective_v2 if version == "v2" else _perspective_v1)(sd, **geometry)
    return sd


def _outliers(sd, channels: int, gain: float, gen) -> None:
    """``channels`` seeded channels of each ViT block's ``norm1`` and
    ``norm2`` scaled by ``gain``, the same inputs of ``attn.qkv`` and of the
    MLP's first linear by ``1 / gain``."""
    mantissa, _ = math.frexp(gain)
    if mantissa != 0.5:
        raise ValueError(f"outlier gain {gain} is not a power of two")
    for norm in [k for k in sd if re.search(r"blocks\.\d+\.norm[12]\.weight$", k)]:
        block = norm.rsplit(".", 2)[0]
        nexts = ([f"{block}.attn.qkv.weight"] if norm.endswith("norm1.weight")
                 else [k for k in (f"{block}.mlp.fc1.weight", f"{block}.mlp.w12.weight") if k in sd])
        picked = torch.randperm(sd[norm].numel(), generator=gen, device=sd[norm].device)[:channels]
        sd[norm][picked] *= gain
        for k in nexts:
            sd[k][:, picked] /= gain


def _perspective_v2(sd, focal: float, z: float, tilt: float, eps: float, mask_logit: float) -> None:
    """The neck's finest UV input reaches its channels 0 and 1, the points
    head carries them to its output as (u, v, z + tilt u) / focal for x and
    y; every random path into those channels and into the output is scaled
    by ``eps``."""
    w = sd["neck.input_blocks.4.weight"]
    w[:2] = 0.0
    w[0, 0, 0, 0] = w[1, 1, 0, 0] = 1.0
    sd["neck.input_blocks.4.bias"][:2] = 0.0
    for stack in ("neck", "points_head"):
        sd[f"{stack}.resamplers.3.1.weight"][:2] *= eps
        sd[f"{stack}.resamplers.3.1.bias"][:2] = 0.0
    w = sd["points_head.input_blocks.4.weight"]
    w[:2] = 0.0
    w[0, 0, 0, 0] = w[1, 1, 0, 0] = 1.0
    sd["points_head.input_blocks.4.bias"][:2] = 0.0
    out = sd["points_head.output_blocks.4.weight"]
    out *= eps
    out[:, :2] = torch.tensor([[1.0 / focal, 0.0], [0.0, 1.0 / focal], [tilt, 0.0]])[..., None, None]
    sd["points_head.output_blocks.4.bias"].copy_(torch.tensor([0.0, 0.0, z]))
    sd["mask_head.output_blocks.4.bias"].fill_(mask_logit)


def _perspective_v1(sd, focal: float, z: float, tilt: float, eps: float, mask_logit: float) -> None:
    """The points block's first conv takes the UV appended to its input
    (its last two channels) at the centre tap into channels u, -u, v, -v,
    which its ReLU keeps as positive parts; its last conv recombines them
    into (u / focal, v / focal, z + tilt u); every random path into those
    channels and into the output is scaled by ``eps``."""
    conv_in = sd["head.output_block.0.0.weight"]
    c = conv_in.shape[1] - 2
    conv_in[:4] *= eps
    for ch, (src, sign) in enumerate(((c, 1.0), (c, -1.0), (c + 1, 1.0), (c + 1, -1.0))):
        conv_in[ch, src, 1, 1] += sign
    sd["head.output_block.0.0.bias"][:4] = 0.0
    names = sorted(k for k in sd if k.startswith("head.output_block.0.") and k.endswith(".weight"))
    conv_out = sd[names[-1]]
    k = conv_out.shape[-1] // 2
    conv_out *= eps
    for o, ch, v in ((0, 0, 1 / focal), (0, 1, -1 / focal), (1, 2, 1 / focal), (1, 3, -1 / focal),
                     (2, 0, tilt), (2, 1, -tilt)):
        conv_out[o, ch, k, k] += v
    sd[names[-1][:-len("weight")] + "bias"].copy_(torch.tensor([0.0, 0.0, z]))
    mask_names = sorted(k for k in sd if k.startswith("head.output_block.1.") and k.endswith(".bias"))
    sd[mask_names[-1]].fill_(mask_logit)


def images(seed: int, count: int, height: int, width: int, device, chunk: int = 32) -> torch.Tensor:
    """``count`` distinct smooth RGB images (count, H, W, 3) in [0, 1] on the
    host, fp32: seeded low-frequency fields with some finer texture, drawn
    on the device in chunks."""
    gen = torch.Generator(device=device).manual_seed((seed * 7919 + 17) % (1 << 63))
    out = torch.empty(count, height, width, 3)
    for start in range(0, count, chunk):
        n = min(chunk, count - start)
        coarse = torch.rand(n, 3, 6, 8, generator=gen, device=device)
        fine = torch.rand(n, 3, 48, 64, generator=gen, device=device)
        img = 0.8 * torch.nn.functional.interpolate(coarse, (height, width), mode="bicubic", align_corners=False)
        img += 0.2 * torch.nn.functional.interpolate(fine, (height, width), mode="bilinear", align_corners=False)
        out[start:start + n] = img.clamp(0.0, 1.0).permute(0, 2, 3, 1).cpu()
    return out
