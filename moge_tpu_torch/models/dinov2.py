"""DINOv2 vision transformer (port of moge_tpu/models/dinov2.py).

The paths MoGe uses: patch embed -> bicubic-interpolated pos-embed (with
the historical 0.1 offset) -> pre-LN blocks with LayerScale (the MLP ffn,
or for the giant the fused SwiGLU) ->
``get_intermediate_layers`` with the shared final LayerNorm. Parameter
names are the torch DINOv2 state-dict names, so a reference checkpoint (or
``moge_tpu.models.convert.export_dinov2_backbone``) loads strictly.

Activations are (B, N, D) tokens; images NHWC. LayerNorm runs kernel K1 and
attention kernel K2 (backward: K2b-dq, K2b-dkv) on the card. GELU is the
tanh approximation under bf16 and exact erf in fp32, as in the JAX package.

Two inference-only compute paths, as in the JAX package: ``use_int8`` makes
the six block projections (qkv, proj, fc1, fc2, w12, w3) W8A8 int8
(``ops/quant.py``; same parameters), and ``forward(..., sp_group=g)`` splits
the token axis over the ranks of a process group (``parallel/sp.py``): the
patch embed and pos-embed run replicated, each rank keeps one contiguous
chunk of the tokens (zero-padded at the global tail), attention gathers K
and V over the group and masks the padding keys (K2 at Nq = chunk, Nkv =
ranks x chunk, ``kv_valid`` = the real tokens), and the final norm's
outputs are gathered.

``remat`` (training, as the JAX package's ``nn.remat(Block)``) runs each
block as an activation checkpoint when grad mode is on (``remat_call``):
the backward keeps each block's input and runs the block's forward again
(two more K1 launches and one more K2 per block). The patch embed, the position
embedding and the final norm stay outside.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention, flash_attention_qkv
from ..ops.norm import layer_norm_fp32
from ..ops.quant import QuantLinear
from ..ops.resize import resize_2d
from ..parallel.sp import gather_tokens, shard_tokens
from ..utils.tools import span
from ._weights import cast, derived, remat_call

__all__ = ["ViTConfig", "VIT_ARCHS", "DinoVisionTransformer"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    embed_dim: int
    depth: int
    num_heads: int
    mlp_ratio: float = 4.0
    patch_size: int = 14
    pos_grid: int = 37  # img_size 518 / patch 14
    interpolate_offset: float = 0.1
    ffn: str = "mlp"  # "mlp" | "swiglu"

    @property
    def mlp_hidden(self) -> int:
        """The ffn's hidden width; SwiGLUFFNFused sizes it 2/3 * 4d, rounded
        up to a multiple of 8 (reference dinov2/layers/swiglu_ffn.py)."""
        hidden = int(self.embed_dim * self.mlp_ratio)
        if self.ffn == "swiglu":
            hidden = (int(self.embed_dim * self.mlp_ratio * 2 / 3) + 7) // 8 * 8
        return hidden


# Hub architectures (LayerScale, no register tokens; the giant with the fused
# SwiGLU ffn, the others the MLP); ``dinov2_vitt14`` is the tiny test arch (no
# checkpoint).
VIT_ARCHS = {
    "dinov2_vits14": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "dinov2_vitb14": ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "dinov2_vitl14": ViTConfig(embed_dim=1024, depth=24, num_heads=16),
    "dinov2_vitg14": ViTConfig(embed_dim=1536, depth=40, num_heads=24, ffn="swiglu"),
    "dinov2_vitt14": ViTConfig(embed_dim=192, depth=4, num_heads=3),
}


class Linear(nn.Linear):
    """nn.Linear whose fp32 parameters are cast to the input dtype (cached for inference)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, cast(self, "weight", x.dtype), cast(self, "bias", x.dtype))


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and fp32 affine (kernel K1 on the card)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_fp32(x, self.weight, self.bias, self.eps)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * cast(self, "gamma", x.dtype)


def _linear(use_int8: bool) -> type:
    """The block projections' class: ``QuantLinear`` (W8A8 int8) or ``Linear``."""
    return QuantLinear if use_int8 else Linear


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, use_int8: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = _linear(use_int8)(dim, dim * 3)
        self.proj = _linear(use_int8)(dim, dim)

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        """``sp``: (group, real tokens) when ``x`` is this rank's chunk of a
        sequence-parallel forward."""
        b, n, dim = x.shape
        qkv = self.qkv(x).view(b, n, 3, self.num_heads, dim // self.num_heads)
        if sp is None:
            # the kernels read q/k/v as strided (B, N, H, 64) views of qkv and
            # write its gradient the same way
            out = flash_attention_qkv(qkv)
        else:
            group, n_total = sp
            kv = gather_tokens(qkv[:, :, 1:], group)  # every rank's K and V, one collective
            out = flash_attention(qkv[:, :, 0], kv[:, :, 0], kv[:, :, 1], kv_valid=n_total)
        return self.proj(out.reshape(b, n, dim))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, use_int8: bool = False):
        super().__init__()
        self.fc1 = _linear(use_int8)(dim, hidden)
        self.fc2 = _linear(use_int8)(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        h = F.gelu(h, approximate="tanh" if h.dtype == torch.bfloat16 else "none")
        return self.fc2(h)


class SwiGLU(nn.Module):
    """SwiGLUFFNFused (the giant arch): one fused linear to 2 x hidden, split
    into x1 and x2, then ``w3(silu(x1) * x2)``. The whole feed-forward is the
    span ``moge.encoder.ffn`` (CUDA events, no range: inside ``moge.encoder``
    an operator range would take the kernels the ctypes wrappers launch)."""

    def __init__(self, dim: int, hidden: int, use_int8: bool = False):
        super().__init__()
        self.w12 = _linear(use_int8)(dim, 2 * hidden)
        self.w3 = _linear(use_int8)(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("moge.encoder.ffn", device=True, host_range=False):
            x1, x2 = self.w12(x).chunk(2, dim=-1)
            return self.w3(F.silu(x1) * x2)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_hidden: int, ffn: str = "mlp", use_int8: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, use_int8)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim)
        if ffn not in ("mlp", "swiglu"):
            raise ValueError(f"unknown ffn {ffn!r}")
        self.mlp = (SwiGLU if ffn == "swiglu" else Mlp)(dim, mlp_hidden, use_int8)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x), sp))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    """Stride-p conv with kernel == stride, computed as reshape + one matmul."""

    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, dim, patch_size, patch_size)  # parameter container only

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        b, hpix, wpix, _ = image.shape
        p = self.patch_size
        h0, w0 = hpix // p, wpix // p
        x = image.reshape(b, h0, p, w0, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, h0 * w0, p * p * 3)
        dim = self.proj.weight.shape[0]
        # (D, 3, p, p) -> (p*p*3, D) in (kh, kw, c) order, matching the patch flattening
        kernel = derived(self, ("kernel", x.dtype),
                         lambda w: w.permute(2, 3, 1, 0).reshape(p * p * 3, dim).to(x.dtype),
                         self.proj.weight)
        return x @ kernel + cast(self.proj, "bias", x.dtype)


class DinoVisionTransformer(nn.Module):
    def __init__(self, config: ViTConfig, use_int8: bool = False, remat: bool = False):
        super().__init__()
        self.config = config
        self.remat = remat
        dim = config.embed_dim
        self.patch_embed = PatchEmbed(config.patch_size, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, config.pos_grid ** 2 + 1, dim))
        # unused by MoGe (so not trained); kept for the checkpoint layout
        self.mask_token = nn.Parameter(torch.zeros(1, dim), requires_grad=False)
        self.blocks = nn.ModuleList(Block(dim, config.num_heads, config.mlp_hidden, config.ffn, use_int8)
                                    for _ in range(config.depth))
        self.norm = LayerNorm(dim)

    def interpolate_pos_encoding(self, h0: int, w0: int, dtype: torch.dtype) -> torch.Tensor:
        """Bicubic pos-embed interpolation with the 0.1 offset, computed in
        fp32 and then cast to ``dtype``."""
        cfg = self.config
        M = cfg.pos_grid
        if h0 == M and w0 == M:
            return cast(self, "pos_embed", dtype)

        def interp(pe):
            dim = pe.shape[-1]
            patch_pe = pe[:, 1:].float().reshape(1, M, M, dim)
            # torch samples a given scale_factor with 1/scale_factor: the offset
            # moves the sampling grid, not the output size
            sf = ((h0 + cfg.interpolate_offset) / M, (w0 + cfg.interpolate_offset) / M)
            patch_pe = resize_2d(patch_pe, (h0, w0), mode="bicubic", scale_factor=sf)
            return torch.cat([pe[:, :1].float(), patch_pe.reshape(1, h0 * w0, dim)], dim=1).to(dtype)

        # one cached grid per dtype: a server sees many grids
        return derived(self, ("pos_embed", dtype), interp, self.pos_embed, tag=(h0, w0))

    def forward(self, image: torch.Tensor, take_layers: Sequence[int], dtype: torch.dtype,
                sp_group=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """``image``: (B, 14*h0, 14*w0, 3) ImageNet-normalized NHWC fp32.
        Returns [(patch tokens (B, h0*w0, D), cls token (B, D)), ...] for the
        blocks in ``take_layers``, each through the shared final norm.
        ``sp_group``: a process group whose ranks all call with the same
        inputs, to run sequence-parallel (inference only: raises with grad
        mode on); every rank returns the whole result."""
        if sp_group is not None and torch.is_grad_enabled():
            raise RuntimeError("sequence parallelism is inference-only: run the forward under "
                               "torch.inference_mode() or torch.no_grad()")
        cfg = self.config
        b, hpix, wpix, _ = image.shape
        h0, w0 = hpix // cfg.patch_size, wpix // cfg.patch_size
        dim = cfg.embed_dim
        x = self.patch_embed(image.to(dtype))
        cls = cast(self, "cls_token", dtype).expand(b, 1, dim)
        x = torch.cat([cls, x], dim=1) + self.interpolate_pos_encoding(h0, w0, dtype)
        n_total = x.shape[1]
        sp = None
        if sp_group is not None:
            x, sp = shard_tokens(x, sp_group), (sp_group, n_total)

        take = set(int(i) for i in take_layers)
        outputs = []
        for i, block in enumerate(self.blocks):
            x = remat_call(block, self.remat, x, sp)
            if i in take:
                outputs.append(x)
        results = []
        for out in outputs:
            out = self.norm(out)  # per token: on the chunk under sequence parallelism
            if sp is not None:
                out = gather_tokens(out, sp_group)[:, :n_total]
            results.append((out[:, 1:], out[:, 0]))
        return results
