"""The benchmark's yardstick: the H100's peaks, and the operations and bytes
of the work that a cell's shapes need.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at the full 700 W): 3.35 TB/s
of HBM; 989 TFLOP/s of bf16 on the tensor cores; outside them 132 SMs x
128 FP32 lanes, one FMA (2 flops) per lane per clock at the maximum SM
clock of 1.98 GHz, 66.9 TFLOP/s. An fp32 configuration (TF32 off) is held
to the FP32 rate.

A kernel's least time is the larger of its operations over the peak of its
dtype and its bytes over the HBM rate, each input byte read once and each
output written once, masked or padded work not counted. The counts follow
the model's shapes, not the program's code: a 3x3 conv after a bilinear 2x
upsample is counted at the output resolution, and the last conv of a
MoGe-2 head is counted folded with the 1x1 projection after it (the least
work that gives the same map). ``model_flops`` counts the model's
multiply-adds as published (unfolded), for ``mfu``. The architectures'
widths, depths, heads and feed-forwards are the reference's table
(``reference/vit.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .reference.vit import ARCHS, ffn_hidden

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 132 * 128 * 2 * 1.98e9}
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def least_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time (s) of ``flops`` operations moving ``nbytes`` bytes."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


# -- attention (K2) --------------------------------------------------------------

def attention_fwd(batch: int, heads: int, n: int, head_dim: int, dtype: str) -> Tuple[float, float]:
    """(flops, bytes) of one attention forward: QK^T and PV, q, k, v read, o written."""
    return 4.0 * batch * heads * n * n * head_dim, 4.0 * batch * n * heads * head_dim * ELEM_BYTES[dtype]


# -- 3x3 convolutions (K3) --------------------------------------------------------

Conv = Dict[str, Any]  # B, H, W (output), C, O, residual


def _conv(b, h, w, c, o, residual=False) -> Conv:
    return {"B": b, "H": h, "W": w, "C": c, "O": o, "residual": residual}


def conv3x3(conv: Conv, dtype: str, up2: bool = False) -> Tuple[float, float]:
    """(flops, bytes) of a replicate-pad 3x3 conv: the input read (at half the
    output's size after an ``up2`` upsample), weights read, output written,
    and the residual read where one is added."""
    b, h, w, c, o = conv["B"], conv["H"], conv["W"], conv["C"], conv["O"]
    pixels_in = b * h * w // (4 if conv.get("up2") or up2 else 1)
    elems = pixels_in * c + 9 * c * o + b * h * w * o * (2 if conv["residual"] else 1)
    return 2.0 * 9 * c * o * b * h * w, elems * ELEM_BYTES[dtype]


def _listify(v, n):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def _stack(cfg: Dict[str, Any], b: int, gh: int, gw: int, fold: bool) -> List[Conv]:
    """The 3x3 convs of a MoGe-2 ConvStack at base grid (gh, gw)."""
    d = cfg["dim_res_blocks"]
    n = len(d)
    counts = _listify(cfg.get("num_res_blocks", 1), n)
    types = _listify(cfg["resamplers"], n - 1)
    dims_out = _listify(cfg["dim_out"], n)
    hidden = cfg.get("dim_times_res_block_hidden", 1)
    fuse_last = fold and counts[n - 1] == 0 and dims_out[n - 1] is not None
    out = []
    for i in range(n):
        h, w = gh * 2 ** i, gw * 2 ** i
        for _ in range(counts[i]):
            out += [_conv(b, h, w, d[i], hidden * d[i]), _conv(b, h, w, hidden * d[i], d[i], residual=True)]
        if i < n - 1:
            o = dims_out[n - 1] if (fuse_last and i == n - 2) else d[i + 1]
            c = d[i + 1] if types[i] == "conv_transpose" else d[i]
            conv = _conv(b, 2 * h, 2 * w, c, o)
            conv["up2"] = types[i] == "bilinear"
            out.append(conv)
    return out


def k3_convs(version: str, cfg: Dict[str, Any], batch: int, height: int, width: int, num_tokens: int) -> List[Conv]:
    """Every 3x3 conv of one forward of the decoder, in its least form."""
    gh, gw, rh, rw = grid(version, cfg, height, width, num_tokens)
    if version == "v2":
        out = _stack(cfg["neck"], batch, gh, gw, fold=False)
        for name in ("points_head", "normal_head", "mask_head"):
            if cfg.get(name) is not None:
                out += _stack(cfg[name], batch, gh, gw, fold=True)
        return out
    out, h, w = [], gh, gw
    hidden = cfg["dim_times_res_block_hidden"]
    for c in cfg["dim_upsample"]:
        h, w = 2 * h, 2 * w
        out.append(_conv(batch, h, w, c, c))
        for _ in range(cfg["num_res_blocks"]):
            out += [_conv(batch, h, w, c, hidden * c), _conv(batch, h, w, hidden * c, c, residual=True)]
    for _ in range(2):
        out.append(_conv(batch, rh, rw, cfg["dim_upsample"][-1] + 2, cfg["last_conv_channels"]))
    return out


def grid(version: str, cfg: Dict[str, Any], height: int, width: int, num_tokens: int) -> Tuple[int, int, int, int]:
    """(token rows, token columns, network input height, width) of an image."""
    if version == "v2":
        ar = width / height
        gh, gw = round((num_tokens / ar) ** 0.5), round((num_tokens * ar) ** 0.5)
        return gh, gw, 14 * gh, 14 * gw
    factor = ((num_tokens * 14 ** 2) / (height * width)) ** 0.5
    rh, rw = int(height * factor), int(width * factor)
    return rh // 14, rw // 14, rh, rw


def vit_flops(arch: str, batch: int, tokens: int) -> float:
    """Multiply-adds x 2 of a DINOv2 forward over ``tokens`` patches (+ cls):
    a block's qkv and projection, its feed-forward (the MLP's two linears,
    8 D^2 a token; the fused SwiGLU's D -> 2 hidden and hidden -> D, 3 D
    hidden a token) and its attention's QK^T and PV."""
    dim, depth, _, ffn = ARCHS[arch]
    n = tokens + 1
    ffn_macs = 3 * dim * ffn_hidden(arch) if ffn == "swiglu" else 8 * dim * dim
    block = 2.0 * n * (3 * dim * dim + dim * dim + ffn_macs) + 4.0 * n * n * dim
    return batch * (2.0 * tokens * 3 * 14 * 14 * dim + depth * block)


def _mm(b, h, w, c, o) -> float:
    return 2.0 * b * h * w * c * o


def _stack_flops(cfg: Dict[str, Any], b: int, gh: int, gw: int) -> float:
    d = cfg["dim_res_blocks"]
    n = len(d)
    dims_in = _listify(cfg["dim_in"], n)
    dims_out = _listify(cfg["dim_out"], n)
    types = _listify(cfg["resamplers"], n - 1)
    total = sum(conv3x3(c, "float32")[0] for c in _stack(cfg, b, gh, gw, fold=False))
    for i in range(n):
        h, w = gh * 2 ** i, gw * 2 ** i
        if dims_in[i] is not None:
            total += _mm(b, h, w, dims_in[i], d[i])
        if dims_out[i] is not None:
            total += _mm(b, h, w, d[i], dims_out[i])
        if i < n - 1 and types[i] == "conv_transpose":
            total += _mm(b, h, w, d[i], 4 * d[i + 1])
    return total


def model_flops(version: str, cfg: Dict[str, Any], batch: int, height: int, width: int, num_tokens: int) -> float:
    """Operations of one forward as published: the ViT, the projections, the
    convs and transposed convs, the heads, the scale MLP."""
    gh, gw, rh, rw = grid(version, cfg, height, width, num_tokens)
    if version == "v2":
        enc = cfg["encoder"]
        dim = ARCHS[enc["backbone"]][0]
        total = vit_flops(enc["backbone"], batch, gh * gw)
        total += len(enc["intermediate_layers"]) * _mm(batch, gh, gw, dim, enc["dim_out"])
        total += _stack_flops(cfg["neck"], batch, gh, gw)
        for name in ("points_head", "normal_head", "mask_head"):
            if cfg.get(name) is not None:
                total += _stack_flops(cfg[name], batch, gh, gw)
        dims = cfg["scale_head"]["dims"]
        return total + sum(2.0 * batch * a * b for a, b in zip(dims[:-1], dims[1:]))
    dim = ARCHS[cfg["encoder"]][0]
    layers = cfg["intermediate_layers"]
    total = vit_flops(cfg["encoder"], batch, gh * gw)
    total += (layers if isinstance(layers, int) else len(layers)) * _mm(batch, gh, gw, dim, cfg["dim_proj"])
    total += sum(conv3x3(c, "float32")[0] for c in k3_convs(version, cfg, batch, height, width, num_tokens))
    h, w, c_in = gh, gw, cfg["dim_proj"]
    for c in cfg["dim_upsample"]:
        total += _mm(batch, h, w, c_in + 2, 4 * c)
        h, w, c_in = 2 * h, 2 * w, c
    k = cfg["last_conv_size"]
    return total + _mm(batch, rh, rw, cfg["last_conv_channels"] * k * k, 3 + 1)


def k2_least_s(version: str, cfg: Dict[str, Any], batch: int, height: int, width: int, num_tokens: int,
               dtype: str) -> float:
    """Least time of the attention forwards of one model forward."""
    gh, gw, _, _ = grid(version, cfg, height, width, num_tokens)
    arch = cfg["encoder"]["backbone"] if version == "v2" else cfg["encoder"]
    dim, depth, heads, _ = ARCHS[arch]
    return depth * least_s(*attention_fwd(batch, heads, gh * gw + 1, dim // heads, dtype), dtype)


def k3_least_s(version: str, cfg: Dict[str, Any], batch: int, height: int, width: int, num_tokens: int,
               dtype: str) -> float:
    """Least time of the 3x3 convs of one model forward."""
    return sum(least_s(*conv3x3(c, dtype), dtype) for c in k3_convs(version, cfg, batch, height, width, num_tokens))
