"""MoGe building blocks, NHWC (port of moge_tpu/models/modules.py).

The DINOv2 encoder wrapper, the residual conv block with its norms (fp32
statistics), activations and skip projection, the seven resampler flavours,
the MLP, the per-level UV maps and the ConvStack pyramid with its folded
finest-level epilogue. Module and parameter names are the microsoft/MoGe
state-dict names. 3x3 convs run kernel K3 on the card (its backward in plain
PyTorch); other kernel sizes and the norms are plain PyTorch, as the JAX
package leaves them to XLA. Every parameter is differentiable. ``remat``
(training) checkpoints the ViT blocks (``DINOv2Encoder``) and each residual
block and resampler of a ``ConvStack``, as the JAX package's ``nn.remat``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv3x3_replicate, depth_to_space2, up2_conv3_expanded
from ..ops.resize import resize_2d
from ._weights import cast, derived, remat_call
from .dinov2 import VIT_ARCHS, DinoVisionTransformer, LayerNorm, Linear

__all__ = ["DINOv2Encoder", "ResidualConvBlock", "ConvTranspose2x", "Resampler", "MLP", "Norm2d",
           "ConvStack", "Conv1x1", "Conv3x3", "conv2d", "make_level_uv", "init_params"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

RESAMPLERS = ("pixel_shuffle", "nearest", "bilinear", "conv_transpose", "pixel_unshuffle", "avg_pool", "max_pool")

_ACTIVATIONS = {
    "relu": (nn.ReLU, F.relu),
    "leaky_relu": (lambda: nn.LeakyReLU(0.2), lambda x: F.leaky_relu(x, 0.2)),
    "silu": (nn.SiLU, F.silu),
    "elu": (nn.ELU, F.elu),
}


def _activation(name: str):
    """(module class, function) of an activation's config name (JAX ``_activation``)."""
    if name not in _ACTIVATIONS:
        raise ValueError(f"Unsupported activation function: {name}")
    return _ACTIVATIONS[name]


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
        # the pixels as rows of one product, whatever x's strides: ``x @ m``
        # would pick that or a batched product by x's strides and by whether m
        # requires grad, which a program's constants never do
        y = x.reshape(-1, x.shape[-1]) @ self.matrix(x.dtype)
        return y.view(*x.shape[:-1], -1) + cast(self, "bias", x.dtype)


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """torch conv weight (..., O, I, kh, kw) -> (..., kh, kw, I, O)."""
    return w.movedim((-4, -3), (-1, -2))


def _fold_linear(kernel: torch.Tensor, bias: torch.Tensor, fold_w: torch.Tensor, fold_b: torch.Tensor):
    """A conv's (..., 3, 3, C, O) kernel and (..., O) bias followed by a 1x1
    conv of torch weight (..., P, O, 1, 1) and bias (..., P) -> the (..., 3,
    3, C, P) kernel and (..., P) bias of their composition (exact linear
    algebra, in the inputs' fp32). Leading axes stack independent convs."""
    m = fold_w[..., 0, 0].transpose(-1, -2)
    return torch.einsum("...hwco,...op->...hwcp", kernel, m), (bias.unsqueeze(-2) @ m).squeeze(-2) + fold_b


def _fold_input(w_in: torch.Tensor, b_in: torch.Tensor, w_out: torch.Tensor):
    """A 1x1 conv (torch weight (..., D, C, 1, 1), bias (..., D)) followed by
    a 1x1 conv of weight (..., P, D, 1, 1) without its bias -> the (..., C,
    P) matrix and (..., P) bias of their composition, in the inputs' fp32."""
    m_out = w_out[..., 0, 0].transpose(-1, -2)
    return w_in[..., 0, 0].transpose(-1, -2) @ m_out, (b_in.unsqueeze(-2) @ m_out).squeeze(-2)


class Conv3x3(nn.Module):
    """3x3 replicate-pad conv (torch weight (O, I, 3, 3)) on NHWC, kernel K3."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                input_relu: bool = False, fold: Optional[Conv1x1] = None) -> torch.Tensor:
        """[ReLU,] conv [then the 1x1 ``fold``, folded into the kernel in fp32
        before the cast to the compute dtype] [+ residual]."""
        if fold is None:
            kernel = derived(self, ("hwio", x.dtype), lambda w: _hwio(w).contiguous().to(x.dtype), self.weight)
            return conv3x3_replicate(x, kernel, self.bias, residual, input_relu)

        def folded(w, b, fold_w, fold_b):
            kernel, b = _fold_linear(_hwio(w), b, fold_w, fold_b)
            return kernel.to(x.dtype).contiguous(), b

        kernel, bias = derived(self, ("folded", x.dtype), folded, self.weight, self.bias, fold.weight, fold.bias)
        return conv3x3_replicate(x, kernel, bias, residual, input_relu)

    def forward_up2(self, x: torch.Tensor, fold: Optional[Conv1x1] = None) -> torch.Tensor:
        """Bilinear-2x upsample then this conv [then the 1x1 ``fold``], as one
        K3 conv at the low resolution plus a depth-to-space. The fold is
        exact linear algebra done in fp32 (kernel @ fold_w, bias @ fold_w +
        fold_b) before the parity expansion; the cast to the compute dtype
        comes last. For inference the expanded weights are built once and
        cached; under autograd they are rebuilt each call, so the gradient
        reaches the original 3x3 (and fold) weights."""

        def expand(w, b, *fold_params):
            kernel = _hwio(w)
            if fold_params:
                kernel, b = _fold_linear(kernel, b, *fold_params)
            return up2_conv3_expanded(kernel, b, x.dtype)

        params = (self.weight, self.bias) + (() if fold is None else (fold.weight, fold.bias))
        wq, bq = derived(self, ("up2", x.dtype, fold is not None), expand, *params)
        return depth_to_space2(conv3x3_replicate(x, wq, bq))


class ConvKxK(nn.Module):
    """k x k replicate-pad conv (k not 1 or 3) on NHWC, in plain PyTorch: a
    replicate pad and ``F.conv2d`` in the compute dtype (the JAX package
    runs these through XLA's ``nn.Conv``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        weight, bias = cast(self, "weight", x.dtype), cast(self, "bias", x.dtype)
        xp = F.pad(x.permute(0, 3, 1, 2), (k // 2,) * 4, mode="replicate")
        return F.conv2d(xp, weight, bias).permute(0, 2, 3, 1)


def conv2d(in_channels: int, out_channels: int, kernel_size: int = 3) -> nn.Module:
    """The replicate-pad conv of a kernel size: K3 for 3x3, a matmul for 1x1,
    plain otherwise."""
    if kernel_size == 3:
        return Conv3x3(in_channels, out_channels)
    if kernel_size == 1:
        return Conv1x1(in_channels, out_channels)
    return ConvKxK(in_channels, out_channels, kernel_size)


class Norm2d(nn.Module):
    """Config-selected norm over NHWC with fp32 statistics (JAX ``Norm2d``):
    'group_norm' (C/32 groups) and 'layer_norm' (one group: over H, W and C,
    not kernel K1's per-row LayerNorm) with fp32 affine parameters,
    'instance_norm' without them, 'none'. eps 1e-5, as torch's."""

    def __init__(self, kind: str, channels: int):
        super().__init__()
        if kind not in ("none", "instance_norm", "group_norm", "layer_norm"):
            raise ValueError(f"Unsupported norm: {kind}")
        self.kind = kind
        self.groups = channels // 32 if kind == "group_norm" else 1
        if kind in ("group_norm", "layer_norm"):
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "none":
            return x
        b, h, w, c = x.shape
        if self.kind == "instance_norm":
            x32, dims = x.float(), (1, 2)
        else:
            x32, dims = x.float().reshape(b, h, w, self.groups, c // self.groups), (1, 2, 4)
        mean = x32.mean(dims, keepdim=True)
        var = (x32 - mean).square().mean(dims, keepdim=True)
        y = ((x32 - mean) * torch.rsqrt(var + 1e-5)).reshape(b, h, w, c)
        if self.kind != "instance_norm":
            y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class ResidualConvBlock(nn.Module):
    """[norm, act, conv3, norm, act, conv3] + skip (a 1x1 projection when the
    channel count changes). A ReLU is fused into the convs (exact: ReLU
    commutes with replicate padding); other activations run between."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 hidden_channels: Optional[int] = None, activation: str = "relu",
                 in_norm: str = "layer_norm", hidden_norm: str = "group_norm"):
        super().__init__()
        out_channels = out_channels or in_channels
        hidden_channels = hidden_channels or in_channels
        act_module, self.act = _activation(activation)
        self.fuse_relu = activation == "relu"
        # indices follow the reference Sequential: 0 norm, 1 act, 2 conv, 3 norm, 4 act, 5 conv
        self.layers = nn.Sequential(Norm2d(in_norm, in_channels), act_module(),
                                    Conv3x3(in_channels, hidden_channels),
                                    Norm2d(hidden_norm, hidden_channels), act_module(),
                                    Conv3x3(hidden_channels, out_channels))
        if in_channels != out_channels:
            self.skip_connection = Conv1x1(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = self.skip_connection(x) if hasattr(self, "skip_connection") else x
        relu = self.fuse_relu
        h = self.layers[0](x)
        h = self.layers[2](h if relu else self.act(h), input_relu=relu)
        h = self.layers[3](h)
        return self.layers[5](h if relu else self.act(h), residual=skip, input_relu=relu)


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


def pixel_shuffle(x: torch.Tensor) -> torch.Tensor:
    """torch PixelShuffle(2) on NHWC: input channels ordered (C, di, dj)."""
    b, h, w, c = x.shape
    return x.reshape(b, h, w, c // 4, 2, 2).permute(0, 1, 4, 2, 5, 3).reshape(b, 2 * h, 2 * w, c // 4)


def pixel_unshuffle(x: torch.Tensor) -> torch.Tensor:
    """torch PixelUnshuffle(2) on NHWC: output channels ordered (C, di, dj)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4).reshape(b, h // 2, w // 2, 4 * c)


def _pool(x: torch.Tensor, fn) -> torch.Tensor:
    return fn(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class Resampler(nn.Sequential):
    """x2 up/down sampler in the seven flavours of the reference
    (``RESAMPLERS``), with the reference's Sequential indices:
    pixel_shuffle (0 conv, 1 shuffle, 2 conv), nearest / bilinear / pixel_unshuffle
    (0 resample, 1 conv), conv_transpose (0 deconv, 1 conv), avg_pool / max_pool
    (0 conv, 1 pool). The bilinear one runs fused (one low-resolution conv)."""

    def __init__(self, in_channels: int, out_channels: int, type_: str):
        if type_ == "pixel_shuffle":
            super().__init__(Conv3x3(in_channels, out_channels * 4), nn.PixelShuffle(2),
                             Conv3x3(out_channels, out_channels))
        elif type_ in ("nearest", "bilinear"):
            super().__init__(nn.Upsample(scale_factor=2, mode=type_), Conv3x3(in_channels, out_channels))
        elif type_ == "conv_transpose":
            super().__init__(ConvTranspose2x(in_channels, out_channels), Conv3x3(out_channels, out_channels))
        elif type_ == "pixel_unshuffle":
            super().__init__(nn.PixelUnshuffle(2), Conv3x3(in_channels * 4, out_channels))
        elif type_ in ("avg_pool", "max_pool"):
            super().__init__(Conv3x3(in_channels, out_channels),
                             nn.AvgPool2d(2) if type_ == "avg_pool" else nn.MaxPool2d(2))
        else:
            raise ValueError(f"Unsupported resampler type: {type_}")
        self.type_ = type_

    def forward(self, x: torch.Tensor, fold: Optional[Conv1x1] = None) -> torch.Tensor:
        """Resample; a following 1x1 ``fold`` goes into the last conv (into
        the first for avg_pool, which commutes with it; max_pool refuses it)."""
        t = self.type_
        if t == "pixel_shuffle":
            return self[2](pixel_shuffle(self[0](x)), fold=fold)
        if t == "bilinear":
            return self[1].forward_up2(x, fold)
        if t == "nearest":
            return self[1](resize_2d(x, (2 * x.shape[1], 2 * x.shape[2]), mode="nearest"), fold=fold)
        if t == "conv_transpose":
            return self[1](self[0](x), fold=fold)
        if t == "pixel_unshuffle":
            return self[1](pixel_unshuffle(x), fold=fold)
        if t == "avg_pool":
            return _pool(self[0](x, fold=fold), F.avg_pool2d)
        if fold is not None:
            raise ValueError("cannot fold a projection through max_pool")
        return _pool(self[0](x), F.max_pool2d)


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
    projection) and the last resampler is not a max_pool, the output
    projection and the finest input projection are folded into the last
    resampler's conv, as in the JAX package. (JAX pads the folded channels
    to at least 32 for its kernel; zero columns change no output, so the
    port does not.) With ``remat`` and grad mode on, each residual block
    and each resampler (the folded one too, its derived weights rebuilt
    inside) runs as an activation checkpoint (``remat_call``)."""

    def __init__(self, dim_in, dim_res_blocks: Sequence[int], dim_out, resamplers,
                 dim_times_res_block_hidden: int = 1, num_res_blocks: Union[int, Sequence[int]] = 1,
                 res_block_in_norm: str = "layer_norm", res_block_hidden_norm: str = "group_norm",
                 activation: str = "relu", remat: bool = False):
        super().__init__()
        self.remat = remat
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
                          and types[n - 2] != "max_pool")

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
            for block in self.res_blocks[i]:
                x = remat_call(block, self.remat, x)
            out_features.append(self.output_blocks[i](x))
            if i < n - 1:
                fold = self.output_blocks[n - 1] if (self.fuse_last and i == n - 2) else None
                x = remat_call(self.resamplers[i], self.remat, x, fold)
        return out_features

    @staticmethod
    def _folded_input(in_proj: nn.Module, out_proj: Conv1x1, feat: torch.Tensor) -> torch.Tensor:
        """``out_proj(in_proj(feat))`` without ``out_proj``'s bias (already in
        the folded conv), as one matmul: weights multiplied in fp32, then cast."""
        if isinstance(in_proj, Conv1x1):
            def fold(w_in, b_in, w_out):
                w, b = _fold_input(w_in, b_in, w_out)
                return w.to(feat.dtype), b.to(feat.dtype)

            w, b = derived(in_proj, ("fold", feat.dtype), fold, in_proj.weight, in_proj.bias, out_proj.weight)
            return feat @ w + b
        return feat @ out_proj.matrix(feat.dtype)


class DINOv2Encoder(nn.Module):
    """ViT encoder wrapper: ImageNet normalisation, intermediate layers,
    1x1 projections summed. ``sp_group`` runs the ViT sequence-parallel over
    a process group, ``use_int8`` its block projections in W8A8 int8 (both
    inference only), ``remat`` its blocks as activation checkpoints
    (training; ``models/dinov2.py``)."""

    def __init__(self, backbone: str, intermediate_layers: Union[int, Sequence[int]], dim_out: int,
                 sp_group=None, use_int8: bool = False, remat: bool = False):
        super().__init__()
        cfg = VIT_ARCHS[backbone]
        self.backbone = DinoVisionTransformer(cfg, use_int8, remat)
        self.sp_group = sp_group
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
        features = self.backbone(image_14, self.take_layers, dtype, self.sp_group)
        b = image_14.shape[0]
        x = None
        for proj, (patches, _cls) in zip(self.output_projections, features):
            y = proj(patches.reshape(b, token_rows, token_cols, -1))
            x = y if x is None else x + y
        return x, features[-1][1]


def init_params(module: nn.Module, seed: int) -> None:
    """Random init with the JAX package's distributions, on the module's
    device: lecun-normal (truncated) kernels, zero biases, pos-embed
    N(0, 0.02), zero cls/mask tokens, LayerScale and norm scales ones."""
    gen = torch.Generator(device=next(module.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for sub in module.modules():
            for leaf, p in sub.named_parameters(recurse=False):
                if leaf == "pos_embed":
                    p.normal_(0.0, 0.02, generator=gen)
                elif leaf in ("bias", "cls_token", "mask_token"):
                    p.zero_()
                elif leaf == "gamma" or isinstance(sub, (LayerNorm, Norm2d)):
                    p.fill_(1.0)
                else:  # torch layout: outputs on dim 0, except ConvTranspose's (I, O, s, s)
                    fan_in = p.numel() // p.shape[1 if isinstance(sub, ConvTranspose2x) else 0]
                    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # flax lecun_normal
                    nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=gen)


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
