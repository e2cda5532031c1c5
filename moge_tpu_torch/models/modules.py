"""MoGe-2 building blocks, NHWC (port of moge_tpu/models/modules.py).

The parts the MoGe-2 presets use: the DINOv2 encoder wrapper, residual
conv blocks without norms, the ``conv_transpose`` and ``bilinear``
resamplers, the MLP, the per-level UV maps and the ConvStack pyramid with
its folded finest-level epilogue. Module and parameter names are the
microsoft/MoGe state-dict names. 3x3 convs run kernel K3 on the card (its
backward in plain PyTorch); every parameter is differentiable.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from ..ops.conv import conv3x3_replicate, depth_to_space2, up2_conv3_expanded
from ._weights import cast, derived
from .dinov2 import VIT_ARCHS, DinoVisionTransformer, Linear

__all__ = ["DINOv2Encoder", "ResidualConvBlock", "ConvTranspose2x", "Resampler", "MLP",
           "ConvStack", "make_level_uv"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Conv1x1(nn.Module):
    """1x1 conv (torch weight (O, I, 1, 1)) applied as a matmul on NHWC."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def matrix(self, dtype: torch.dtype) -> torch.Tensor:
        """The (I, O) matrix in ``dtype`` (cached for inference)."""
        return derived(self, ("matrix", dtype), lambda w: w[:, :, 0, 0].t().to(dtype), self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.matrix(x.dtype) + cast(self, "bias", x.dtype)


class Conv3x3(nn.Module):
    """3x3 replicate-pad conv (torch weight (O, I, 3, 3)) on NHWC, kernel K3."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                input_relu: bool = False) -> torch.Tensor:
        kernel = derived(self, ("hwio", x.dtype), lambda w: w.permute(2, 3, 1, 0).contiguous().to(x.dtype),
                         self.weight)
        return conv3x3_replicate(x, kernel, self.bias, residual, input_relu)

    def forward_up2(self, x: torch.Tensor, fold: Optional[Conv1x1] = None) -> torch.Tensor:
        """Bilinear-2x upsample then this conv [then the 1x1 ``fold``], as one
        K3 conv at the low resolution plus a depth-to-space. The fold is
        exact linear algebra done in fp32 (kernel @ fold_w, bias @ fold_w +
        fold_b) before the parity expansion; the cast to the compute dtype
        comes last. For inference the expanded weights are built once and
        cached; under autograd they are rebuilt each call, so the gradient
        reaches the original 3x3 (and fold) weights."""

        def expand(w, b, *fold_params):
            kernel = w.permute(2, 3, 1, 0)
            if fold_params:
                fold_w = fold_params[0][:, :, 0, 0].t()
                kernel = torch.einsum("hwco,op->hwcp", kernel, fold_w)
                b = b @ fold_w + fold_params[1]
            return up2_conv3_expanded(kernel, b, x.dtype)

        params = (self.weight, self.bias) + (() if fold is None else (fold.weight, fold.bias))
        wq, bq = derived(self, ("up2", x.dtype, fold is not None), expand, *params)
        return depth_to_space2(conv3x3_replicate(x, wq, bq))


class ResidualConvBlock(nn.Module):
    """[norm, act, conv3, norm, act, conv3] + skip, with norms 'none' and the
    ReLU fused into the convs (exact: ReLU commutes with replicate padding)."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 hidden_channels: Optional[int] = None, activation: str = "relu",
                 in_norm: str = "none", hidden_norm: str = "none"):
        super().__init__()
        out_channels = out_channels or in_channels
        hidden_channels = hidden_channels or in_channels
        if activation != "relu" or in_norm != "none" or hidden_norm != "none" or out_channels != in_channels:
            raise NotImplementedError("only ReLU blocks without norms or skip projection are ported yet "
                                      f"(got {activation}/{in_norm}/{hidden_norm}, {in_channels}->{out_channels})")
        # indices follow the reference Sequential: 0 norm, 1 act, 2 conv, 3 norm, 4 act, 5 conv
        self.layers = nn.Sequential(nn.Identity(), nn.ReLU(), Conv3x3(in_channels, hidden_channels),
                                    nn.Identity(), nn.ReLU(), Conv3x3(hidden_channels, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.layers[2](x, input_relu=True)
        return self.layers[5](h, residual=x, input_relu=True)


class ConvTranspose2x(nn.Module):
    """ConvTranspose2d(kernel=2, stride=2) as a matmul plus depth-to-space.
    torch weight (I, O, 2, 2): y[2i+di, 2j+dj, o] = sum_c x[i, j, c] W[c, o, di, dj]."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, 2, 2))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        o = self.weight.shape[1]
        kernel = derived(self, ("matrix", x.dtype),
                         lambda t: t.permute(0, 2, 3, 1).reshape(c, 4 * o).to(x.dtype), self.weight)
        y = (x @ kernel).reshape(b, h, w, 2, 2, o).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, o)
        return y + cast(self, "bias", x.dtype)


class Resampler(nn.Sequential):
    """x2 upsampler: 'conv_transpose' (ConvTranspose2x -> conv3x3) or
    'bilinear' (upsample -> conv3x3, fused into one low-resolution conv)."""

    def __init__(self, in_channels: int, out_channels: int, type_: str):
        if type_ == "conv_transpose":
            super().__init__(ConvTranspose2x(in_channels, out_channels), Conv3x3(out_channels, out_channels))
        elif type_ == "bilinear":
            super().__init__(nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False),
                             Conv3x3(in_channels, out_channels))
        else:
            raise NotImplementedError(f"resampler {type_!r} is not ported yet")
        self.type_ = type_

    def forward(self, x: torch.Tensor, fold: Optional[Conv1x1] = None) -> torch.Tensor:
        if self.type_ == "bilinear":
            return self[1].forward_up2(x, fold)
        return self[1](self[0](x))  # ConvStack folds only into a bilinear resampler


class MLP(nn.Sequential):
    """Linear/ReLU stack (reference names: 0, 2, 4, ... are the Linears)."""

    def __init__(self, dims: Sequence[int]):
        layers: List[nn.Module] = []
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            if i:
                layers.append(nn.ReLU())
            layers.append(Linear(d_in, d_out))
        super().__init__(*layers)


class ConvStack(nn.Module):
    """Multi-scale residual conv pyramid. ``forward`` takes per-level input
    features (or None) and returns per-level outputs; level i runs at 2^i x
    the base resolution.

    When the finest level is purely linear (no res blocks, an output
    projection), the output projection and the finest input projection are
    folded into the last resampler's conv, as in the JAX package."""

    def __init__(self, dim_in, dim_res_blocks: Sequence[int], dim_out, resamplers,
                 dim_times_res_block_hidden: int = 1, num_res_blocks: Union[int, Sequence[int]] = 1,
                 res_block_in_norm: str = "layer_norm", res_block_hidden_norm: str = "group_norm",
                 activation: str = "relu"):
        super().__init__()
        n = len(dim_res_blocks)
        dims_in = dim_in if isinstance(dim_in, (list, tuple)) else [dim_in] * n
        dims_out = dim_out if isinstance(dim_out, (list, tuple)) else [dim_out] * n
        res_counts = num_res_blocks if isinstance(num_res_blocks, (list, tuple)) else [num_res_blocks] * n
        types = resamplers if isinstance(resamplers, (list, tuple)) else [resamplers] * (n - 1)
        self.dim_res_blocks = list(dim_res_blocks)
        self.input_blocks = nn.ModuleList(
            Conv1x1(di, d) if di is not None else nn.Identity() for di, d in zip(dims_in, dim_res_blocks))
        self.res_blocks = nn.ModuleList(
            nn.Sequential(*(ResidualConvBlock(d, d, dim_times_res_block_hidden * d, activation,
                                              res_block_in_norm, res_block_hidden_norm)
                            for _ in range(count)))
            for d, count in zip(dim_res_blocks, res_counts))
        self.resamplers = nn.ModuleList(
            Resampler(dim_res_blocks[i], dim_res_blocks[i + 1], types[i]) for i in range(n - 1))
        self.output_blocks = nn.ModuleList(
            Conv1x1(d, do) if do is not None else nn.Identity() for d, do in zip(dim_res_blocks, dims_out))
        self.fuse_last = (n >= 2 and res_counts[n - 1] == 0 and dims_out[n - 1] is not None
                          and types[n - 2] == "bilinear")

    def forward(self, in_features: List[Optional[torch.Tensor]]) -> List[torch.Tensor]:
        n = len(self.dim_res_blocks)
        out_features: List[torch.Tensor] = []
        x = None
        for i in range(n):
            feat = in_features[i] if i < len(in_features) else None
            in_proj = self.input_blocks[i]
            if self.fuse_last and i == n - 1:
                # x came from the last resampler with the output projection
                # folded in; the finest input projection folds into it too.
                if feat is not None:
                    x = x + self._folded_input(in_proj, self.output_blocks[i], feat.to(x.dtype))
                out_features.append(x)
                break
            if isinstance(in_proj, Conv1x1) and feat is not None:
                feat = in_proj(feat)
            if i == 0:
                x = feat
            elif feat is not None:
                x = x + feat
            x = self.res_blocks[i](x)
            out_features.append(self.output_blocks[i](x))
            if i < n - 1:
                fold = self.output_blocks[n - 1] if (self.fuse_last and i == n - 2) else None
                x = self.resamplers[i](x, fold)
        return out_features

    @staticmethod
    def _folded_input(in_proj: nn.Module, out_proj: Conv1x1, feat: torch.Tensor) -> torch.Tensor:
        """``out_proj(in_proj(feat))`` without ``out_proj``'s bias (already in
        the folded conv), as one matmul: weights multiplied in fp32, then cast."""
        if isinstance(in_proj, Conv1x1):
            def fold(w_in, b_in, w_out):
                m_out = w_out[:, :, 0, 0].t()
                return (w_in[:, :, 0, 0].t() @ m_out).to(feat.dtype), (b_in @ m_out).to(feat.dtype)

            w, b = derived(in_proj, ("fold", feat.dtype), fold, in_proj.weight, in_proj.bias, out_proj.weight)
            return feat @ w + b
        return feat @ out_proj.matrix(feat.dtype)


class DINOv2Encoder(nn.Module):
    """ViT encoder wrapper: ImageNet normalisation, intermediate layers,
    1x1 projections summed."""

    def __init__(self, backbone: str, intermediate_layers: Union[int, Sequence[int]], dim_out: int):
        super().__init__()
        cfg = VIT_ARCHS[backbone]
        self.backbone = DinoVisionTransformer(cfg)
        if isinstance(intermediate_layers, int):
            self.take_layers = tuple(range(cfg.depth - intermediate_layers, cfg.depth))
        else:
            self.take_layers = tuple(intermediate_layers)
        self.output_projections = nn.ModuleList(Conv1x1(cfg.embed_dim, dim_out) for _ in self.take_layers)
        self.register_buffer("image_mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1))
        self.register_buffer("image_std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1))

    def forward(self, image_14: torch.Tensor, token_rows: int, token_cols: int, dtype: torch.dtype):
        """``image_14``: (B, 14*rows, 14*cols, 3) RGB in [0, 1], fp32.
        Returns features (B, rows, cols, dim_out) and the cls token (B, D)."""
        image_14 = (image_14.float() - self.image_mean.view(3)) / self.image_std.view(3)
        features = self.backbone(image_14, self.take_layers, dtype)
        b = image_14.shape[0]
        x = None
        for proj, (patches, _cls) in zip(self.output_projections, features):
            y = proj(patches.reshape(b, token_rows, token_cols, -1))
            x = y if x is None else x + y
        return x, features[-1][1]


def make_level_uv(base_h: int, base_w: int, num_levels: int, aspect_ratio: float, batch: int,
                  dtype: torch.dtype, device=None) -> List[torch.Tensor]:
    """Per-level aspect-ratio UV maps (B, h*2^l, w*2^l, 2), computed in fp32
    with the aspect ratio as a runtime value (the JAX decode program's form)."""
    ar = torch.tensor(aspect_ratio, dtype=torch.float32, device=device)
    span_x = ar / torch.sqrt(1 + ar ** 2)
    span_y = 1 / torch.sqrt(1 + ar ** 2)
    uvs = []
    for level in range(num_levels):
        w, h = base_w * 2 ** level, base_h * 2 ** level
        iu = torch.arange(w, dtype=torch.float32, device=device)
        iv = torch.arange(h, dtype=torch.float32, device=device)
        lo_u, hi_u = -span_x * (w - 1) / w, span_x * (w - 1) / w
        lo_v, hi_v = -span_y * (h - 1) / h, span_y * (h - 1) / h
        u = lo_u + (hi_u - lo_u) * (iu / max(w - 1, 1))
        v = lo_v + (hi_v - lo_v) * (iv / max(h - 1, 1))
        uv = torch.stack(torch.meshgrid(u, v, indexing="xy"), dim=-1).to(dtype)
        uvs.append(uv[None].expand(batch, h, w, 2))
    return uvs
