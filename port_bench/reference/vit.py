"""DINOv2 ViT forward as published: stride-14 patch conv, bicubic
position-embedding interpolation with the 0.1 offset, pre-LN blocks with
LayerScale, the feed-forward of the architecture (the MLP with exact-erf
GELU, or the giant's fused SwiGLU), and the shared final LayerNorm on the
taken layers. Attention is an explicit fp32 softmax.

``ARCHS`` is the benchmark's one table of the architectures: the
checkpoint layout (``models.param_specs``) and the yardstick's counts
(``roofline.py``) read it too."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .lowp import operand

ARCHS = {  # embed_dim, depth, heads, ffn (facebookresearch/dinov2 hubconf; dinov2_vitt14 a tiny test arch)
    "dinov2_vits14": (384, 12, 6, "mlp"),
    "dinov2_vitb14": (768, 12, 12, "mlp"),
    "dinov2_vitl14": (1024, 24, 16, "mlp"),
    "dinov2_vitg14": (1536, 40, 24, "swiglu"),
    "dinov2_vitt14": (192, 4, 3, "mlp"),
}
PATCH = 14
POS_GRID = 37
OFFSET = 0.1
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def ffn_hidden(arch: str) -> int:
    """The feed-forward's hidden width: 4 D for the MLP; for the SwiGLU as
    DINOv2's ``SwiGLUFFNFused`` sizes it, 2/3 of 4 D rounded up to a
    multiple of 8 (4096 at D = 1536)."""
    dim, _, _, ffn = ARCHS[arch]
    return (int(4 * dim * 2 / 3) + 7) // 8 * 8 if ffn == "swiglu" else 4 * dim


def normalize(image: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) RGB in [0, 1] -> ImageNet-normalised."""
    mean = torch.tensor(IMAGENET_MEAN, device=image.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=image.device).view(1, 3, 1, 1)
    return (image - mean) / std


def _pos_embed(pe: torch.Tensor, h: int, w: int) -> torch.Tensor:
    dim = pe.shape[-1]
    grid = pe[:, 1:].reshape(1, POS_GRID, POS_GRID, dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((h + OFFSET) / POS_GRID, (w + OFFSET) / POS_GRID),
                         mode="bicubic", align_corners=False)
    assert grid.shape[-2:] == (h, w)
    return torch.cat([pe[:, :1], grid.permute(0, 2, 3, 1).reshape(1, h * w, dim)], dim=1)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.linear(operand(x), operand(w), b)


def _block(sd: Dict[str, torch.Tensor], p: str, x: torch.Tensor, heads: int, ffn: str) -> torch.Tensor:
    b, n, dim = x.shape
    h = F.layer_norm(x, (dim,), sd[p + "norm1.weight"], sd[p + "norm1.bias"], 1e-6)
    qkv = linear(h, sd[p + "attn.qkv.weight"], sd[p + "attn.qkv.bias"])
    q, k, v = qkv.reshape(b, n, 3, heads, dim // heads).permute(2, 0, 3, 1, 4)
    probs = torch.softmax((operand(q) @ operand(k).transpose(-2, -1)) * (dim // heads) ** -0.5, dim=-1)
    out = (operand(probs) @ operand(v)).transpose(1, 2).reshape(b, n, dim)
    x = x + sd[p + "ls1.gamma"] * linear(out, sd[p + "attn.proj.weight"], sd[p + "attn.proj.bias"])
    h = F.layer_norm(x, (dim,), sd[p + "norm2.weight"], sd[p + "norm2.bias"], 1e-6)
    if ffn == "swiglu":
        x1, x2 = linear(h, sd[p + "mlp.w12.weight"], sd[p + "mlp.w12.bias"]).chunk(2, -1)
        h = linear(F.silu(x1) * x2, sd[p + "mlp.w3.weight"], sd[p + "mlp.w3.bias"])
    else:
        h = linear(F.gelu(linear(h, sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"])),
                   sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"])
    return x + sd[p + "ls2.gamma"] * h


def forward(sd: Dict[str, torch.Tensor], prefix: str, arch: str, image: torch.Tensor,
            take: Sequence[int]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``image`` (B, 3, 14h, 14w) normalised. Returns [(patch tokens (B, h*w,
    D), cls token (B, D))] of the ``take`` blocks, through the final norm."""
    dim, depth, heads, ffn = ARCHS[arch]
    x = F.conv2d(operand(image), operand(sd[prefix + "patch_embed.proj.weight"]), sd[prefix + "patch_embed.proj.bias"],
                 stride=PATCH)
    b, _, h, w = x.shape
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd[prefix + "cls_token"].expand(b, 1, dim), x], dim=1) + _pos_embed(sd[prefix + "pos_embed"], h, w)
    outs = []
    for i in range(depth):
        x = _block(sd, f"{prefix}blocks.{i}.", x, heads, ffn)
        if i in take:
            outs.append(F.layer_norm(x, (dim,), sd[prefix + "norm.weight"], sd[prefix + "norm.bias"], 1e-6))
    return [(o[:, 1:], o[:, 0]) for o in outs]
