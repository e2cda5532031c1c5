"""3x3 replicate-pad convolution, NHWC (port of moge_tpu/ops/conv.py).

``conv3x3_replicate`` launches kernel K3 (``csrc/conv3x3.cu``) for CUDA
tensors and runs ``conv3x3_plain`` for CPU tensors. The plain version is the
math of the JAX package's ``conv3x3_xla``: [ReLU on the input], replicate
pad, VALID 3x3 conv with fp32 accumulation, + bias, + residual in fp32, one
rounding to the input dtype. The backward is the autograd VJP of
``conv3x3_plain`` (x, kernel, bias and residual; ``input_relu`` honoured),
as the JAX package's VJP is an XLA formulation.

``conv3x3_up2_bilinear`` is the bilinear-2x upsample followed by a 3x3
conv, computed as one K3 conv at the low resolution over parity-expanded
weights (``up2_conv3_weights``) and a depth-to-space.

Grouped form (the batched decoder heads): a (G, 3, 3, C, O) kernel with a
(G, O) bias applies weight group b // B0 to batch entry b of a (G*B0, H, W,
C) input, as the JAX package's ``conv3x3_xla`` and ``_conv3x3_pallas`` do.
CUDA tensors run kernel K3-grouped (the same source, the group on the
grid).

For bf16 the kernel is a pipelined implicit GEMM on ``wgmma``; its output
tile and copy width are chosen per launch by ``_tile_config``, which sets
the launch's variant: ``wgmma_tma_cp16`` (weights by TMA, input by 16-byte
cp.async), ``wgmma_cp8`` / ``wgmma_cp4`` (both by 8- or 4-byte cp.async):
the pipelined variants, ``PIPELINED``, which every main-path shape takes;
``wgmma_generic`` (2-byte loads through registers, for an odd C or O or
misaligned pointers). For fp32 (MoGe-1's ``infer`` and every fp32
``infer``) the kernel is a register-blocked FFMA implicit GEMM whose tile
and channel chunk ``_f32_tile`` chooses per launch: variant ``fp32``; an
odd C, an O not a multiple of 4 or a pointer not 16-byte aligned takes the
scalar kernel, variant ``fp32_generic``.

K3 and K3-grouped are the op ``moge::conv3x3(x, kernel, bias, residual,
input_relu)`` (a 5-dim kernel is K3-grouped). Registration, routing and the
launch count (kernels ``conv3x3`` and ``conv3x3_grouped``, each under the
variants above): ``_build``.

Weights use the JAX layout (3, 3, C, O); activations are NHWC.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv3x3_replicate", "conv3x3_plain", "conv3x3_up2_bilinear", "up2_conv3_weights",
           "up2_conv3_expanded", "depth_to_space2", "PIPELINED", "VARIANTS"]

PIPELINED = ("wgmma_tma_cp16", "wgmma_cp8", "wgmma_cp4")  # the bf16 variants that copy asynchronously
VARIANTS = PIPELINED + ("wgmma_generic", "fp32", "fp32_generic")  # every variant a K3 or K3-grouped launch takes

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
K3 = _build.Entry("conv3x3", "conv3x3", "moge_conv3x3", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                  + [ctypes.c_void_p], variants=VARIANTS)
K3_GROUPED = _build.Entry("conv3x3_grouped", "conv3x3", "moge_conv3x3_grouped", [ctypes.c_void_p] * 5
                          + [ctypes.c_int] * 12 + [ctypes.c_void_p], variants=VARIANTS)
N_TILES = (16, 32, 64, 128)  # wgmma widths the bf16 kernel is built for
# the fp32 kernel's builds (csrc/conv3x3.cu): N widths, each over a patch of
# F32_OUTPUTS / N pixels (8 x 16, 16 x 16, 16 x 32), and the blocks an SM
# holds (256 threads at most 128 registers each); per F32_ROUNDS, the time of
# a last round that leaves 1 or 2 blocks on the busiest SM, relative to a
# full round: a fit to CUDA-event times on an H100 (86x114 256 -> 512 in one
# round and one of one block an SM against 172x228 128 -> 256 in two and one
# of one block, which read 0.59)
F32_N_TILES = (32, 64, 128)
F32_OUTPUTS = 16384
F32_PER_SM = 2
F32_ROUNDS = (0.6, 1.0)


class ConvTile(NamedTuple):
    """The bf16 kernel's output tile, an 8 x (bm / 8) patch of pixels by bn
    channels, and the bytes of each copy into shared memory (16: the weights
    by TMA and the input by cp.async; 8, 4: both by cp.async; 2: the generic
    loader)."""
    bm: int
    bn: int
    copy: int

    @property
    def variant(self) -> str:
        return {16: "wgmma_tma_cp16", 8: "wgmma_cp8", 4: "wgmma_cp4", 2: "wgmma_generic"}[self.copy]

    def blocks(self, G: int, B0: int, H: int, W: int, O: int) -> int:
        """Blocks of the launch: G x B0 x patches x N tiles."""
        return G * B0 * -(-H // 8) * -(-W // (self.bm // 8)) * -(-O // self.bn)


@functools.lru_cache(maxsize=1024)
def _tile_config(G: int, B0: int, H: int, W: int, C: int, O: int, sms: int, align: int = 16) -> ConvTile:
    """Tile of the bf16 kernel for G groups of B0 x H x W pixels, C -> O
    channels, on a card of ``sms`` SMs, pointers aligned to ``align`` bytes.
    N: the narrowest width that holds O (O = 12 runs 16 wide), 128 above it
    (more N tiles on the grid). Copy: the widest of 16, 8, 4 bytes that C,
    O and the pointers allow, else 2 (generic). M: 128 pixels (8 x 16) where
    that grid still has at least four blocks per SM (each block then reads
    the weights for twice the pixels), else 64 (8 x 8), so that 74^2 at
    batch 1 (256 -> 256) runs 200 blocks on an H100's 132 SMs."""
    bn = next((n for n in N_TILES if n >= O), N_TILES[-1])
    copy = next((v for v in (16, 8, 4) if C % (v // 2) == 0 and O % (v // 2) == 0 and align % v == 0), 2)
    wide = ConvTile(128, bn, copy)
    if copy == 16 and bn >= 64 and wide.blocks(G, B0, H, W, O) >= 4 * sms:
        return wide
    return ConvTile(64, bn, copy)


class F32Tile(NamedTuple):
    """The fp32 kernel's launch: ``bn`` output channels by ``bm`` pixels (a
    patch of ``patch`` rows by columns), ``chunk`` input channels per K
    step, the input staged ``copy`` bytes at a time (16, or 8 for C % 4 ==
    2); ``copy`` 0 is the generic kernel (64 x 64 tiles)."""
    bm: int
    bn: int
    copy: int
    chunk: int

    @property
    def variant(self) -> str:
        return "fp32" if self.copy else "fp32_generic"

    @property
    def patch(self) -> Tuple[int, int]:
        pw = 32 if self.bn == 32 else 16
        return self.bm // pw, pw

    def blocks(self, G: int, B0: int, H: int, W: int, O: int) -> int:
        """Blocks of the tiled kernel's launch: G x B0 x patches x N tiles."""
        ph, pw = self.patch
        return G * B0 * -(-H // ph) * -(-W // pw) * -(-O // self.bn)


F32_GENERIC = F32Tile(64, 64, 0, 32)


def _f32_finish(blocks: int, sms: int) -> float:
    """Rounds of ``F32_PER_SM`` blocks an SM that ``blocks`` take, the last
    one weighed by the blocks it leaves on the busiest SM (``F32_ROUNDS``)."""
    full, last = divmod(blocks, F32_PER_SM * sms)
    return full * F32_ROUNDS[-1] + (F32_ROUNDS[-(-last // sms) - 1] if last else 0.0)


@functools.lru_cache(maxsize=1024)
def _f32_tile(G: int, B0: int, H: int, W: int, C: int, O: int, sms: int, align: int = 16) -> F32Tile:
    """The fp32 kernel's launch for G groups of B0 x H x W pixels, C -> O
    channels, on a card of ``sms`` SMs, pointers aligned to ``align`` bytes.
    The generic kernel for an odd C, an O not a multiple of 4 or pointers
    not 16-byte aligned. Else the chunk is 16 channels where C is a multiple
    of 16, else 8 (C = 66 runs 72, not 80); the patch copies 16 bytes where C
    is a multiple of 4, else 8. Of the N widths, the one whose launch
    finishes first (``_f32_finish``: every build's block holds the same
    ``F32_OUTPUTS`` outputs, so blocks weigh alike), then the one with the
    fewest blocks, then the widest."""
    if C % 2 or O % 4 or align % 16:
        return F32_GENERIC
    chunk, copy = (16 if C % 16 == 0 else 8), (16 if C % 4 == 0 else 8)
    tiles = [F32Tile(F32_OUTPUTS // bn, bn, copy, chunk) for bn in F32_N_TILES]
    return min(tiles, key=lambda t: (_f32_finish(t.blocks(G, B0, H, W, O), sms), t.blocks(G, B0, H, W, O), -t.bn))


def _alignment(*tensors) -> int:
    """The largest power of two up to 16 that divides every tensor's address."""
    align = 16
    for t in tensors:
        if t is not None:
            while t.data_ptr() % align:
                align //= 2
    return align


def _groups(x: torch.Tensor, kernel: torch.Tensor) -> int:
    """G of a grouped (G, 3, 3, C, O) kernel (raises unless it divides the batch), 0 for a shared one."""
    if kernel.dim() != 5:
        return 0
    G = kernel.shape[0]
    if G <= 0 or x.shape[0] % G:
        raise ValueError(f"grouped conv3x3: batch {x.shape[0]} is not a multiple of the {G} weight groups")
    return G


def conv3x3_plain(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                  residual: Optional[torch.Tensor] = None, input_relu: bool = False) -> torch.Tensor:
    G = _groups(x, kernel)
    if G:  # one shared-weight conv per group of B0 = B // G batch entries
        b0 = x.shape[0] // G
        return torch.cat([conv3x3_plain(x[g * b0:(g + 1) * b0], kernel[g], None if bias is None else bias[g],
                                        None if residual is None else residual[g * b0:(g + 1) * b0], input_relu)
                          for g in range(G)])
    xf = x.float()
    if input_relu:
        xf = xf.clamp_min(0)
    xp = F.pad(xf.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    y = F.conv2d(xp, kernel.float().permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def _launch(x, kernel, bias, residual, input_relu) -> torch.Tensor:
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3x3 kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"conv3x3 kernel takes a contiguous NHWC input, got {tuple(x.shape)}")
    B, H, W, C = x.shape
    G = _groups(x, kernel)
    lead = (G,) if G else ()
    if kernel.dim() != 4 + bool(G) or kernel.shape[len(lead):len(lead) + 3] != (3, 3, C):
        raise ValueError(f"conv3x3 kernel weights must be ([G,] 3, 3, {C}, O), got {tuple(kernel.shape)}")
    O = kernel.shape[-1]
    if kernel.dtype != x.dtype or not kernel.is_contiguous() or kernel.device != x.device:
        raise ValueError("conv3x3 kernel weights must be contiguous, in the input's dtype and device")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (*lead, O)
                             or not bias.is_contiguous() or bias.device != x.device):
        raise ValueError(f"conv3x3 bias must be a contiguous fp32 {(*lead, O)} tensor on {x.device}")
    if residual is not None and (residual.shape != (B, H, W, O) or residual.dtype != x.dtype
                                 or not residual.is_contiguous() or residual.device != x.device):
        raise ValueError(f"conv3x3 residual must be a contiguous ({B}, {H}, {W}, {O}) {x.dtype} tensor")
    y = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    entry, dims = (K3_GROUPED, (G, B // G, H, W, C, O)) if G else (K3, (B, H, W, C, O))
    if x.dtype == torch.bfloat16:
        tile = _tile_config(G or 1, B // (G or 1), H, W, C, O, _build.sm_count(x.device),
                            _alignment(x, kernel, residual, y))
        args = (*tile, 0)
    else:
        tile = _f32_tile(G or 1, B // (G or 1), H, W, C, O, _build.sm_count(x.device),
                         _alignment(x, kernel, bias, residual, y))
        args = tile
    entry(tile.variant, x.device, x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(),
          None if residual is None else residual.data_ptr(), y.data_ptr(), *dims, int(input_relu),
          _DTYPES[x.dtype], *args)
    return y


def _fake(x, kernel, bias, residual, input_relu):
    return x.new_empty((*x.shape[:3], kernel.shape[-1]))


ROUTER = _build.kernel_op("conv3x3(Tensor x, Tensor kernel, Tensor? bias, Tensor? residual, bool input_relu) "
                          "-> Tensor", _launch, conv3x3_plain, _fake)


def conv3x3_replicate(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                      residual: Optional[torch.Tensor] = None, input_relu: bool = False) -> torch.Tensor:
    """3x3 stride-1 NHWC conv with replicate padding and fp32 accumulation.

    ``kernel``: (3, 3, C, O) in the input dtype, or grouped (G, 3, 3, C, O)
    with batch entry b using group b // (B // G); ``bias``: fp32 (O,) or
    (G, O), or None;
    ``residual``: (B, H, W, O) added in fp32 before the rounding;
    ``input_relu``: ReLU on the input (exact: it commutes with the padding).
    CUDA tensors run kernel K3, or K3-grouped for a grouped kernel
    (differentiable: backward in plain PyTorch); CPU tensors run
    ``conv3x3_plain``. Without a gradient to take, a traced program records
    the op ``moge::conv3x3``."""
    return ROUTER(x, kernel, bias, residual, input_relu)


# bilinear 2x (half-pixel, edge-clamped) row coefficients per (output parity
# a, conv row tap du): list of (input offset di, weight). Same for columns.
_UP2_TAPS = {
    (0, 0): [(-1, 0.75), (0, 0.25)],
    (0, 1): [(-1, 0.25), (0, 0.75)],
    (0, 2): [(0, 0.75), (1, 0.25)],
    (1, 0): [(-1, 0.25), (0, 0.75)],
    (1, 1): [(0, 0.75), (1, 0.25)],
    (1, 2): [(0, 0.25), (1, 0.75)],
}


def up2_conv3_weights(kernel: torch.Tensor) -> torch.Tensor:
    """Compose a bilinear 2x upsample (align_corners=False) with a 3x3 conv.

    ([G,] 3, 3, C, O) -> ([G,] 3, 3, C, 2, 2, O): taps over the LOW-res input
    producing the 4 output parities (per weight group). Exact, edges
    included: the upsample's edge clamp and the conv's replicate pad both
    reduce to clamping low-res indices."""
    lead, (C, O) = kernel.shape[:-4], kernel.shape[-2:]
    w = torch.zeros((*lead, 3, 3, C, 2, 2, O), dtype=kernel.dtype, device=kernel.device)
    for a in range(2):
        for b in range(2):
            for du in range(3):
                for dv in range(3):
                    for di, ar in _UP2_TAPS[(a, du)]:
                        for dj, ac in _UP2_TAPS[(b, dv)]:
                            w[..., di + 1, dj + 1, :, a, b, :] += ar * ac * kernel[..., du, dv, :, :]
    return w


def depth_to_space2(y: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4*O) parity-packed channels (a, b, o) -> (B, 2H, 2W, O)."""
    B, H, W, C4 = y.shape
    O = C4 // 4
    return y.reshape(B, H, W, 2, 2, O).permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * W, O)


def up2_conv3_expanded(kernel: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype):
    """([G,] 3, 3, C, O) kernel and ([G,] O) bias of a conv that follows a
    bilinear 2x upsample -> the K3 (K3-grouped) operands of the fused form:
    ([G,] 3, 3, C, 4*O) parity weights in ``dtype`` (expanded in fp32, cast
    last) and the ([G,] 4*O) fp32 bias."""
    lead, (C, O) = kernel.shape[:-4], kernel.shape[-2:]
    wq = up2_conv3_weights(kernel.float()).reshape(*lead, 3, 3, C, 4 * O).to(dtype).contiguous()
    return wq, bias.float().repeat(*([1] * len(lead)), 4).contiguous()


def conv3x3_up2_bilinear(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Bilinear-2x upsample then replicate-pad 3x3 conv, as one K3 conv at the
    low resolution over parity-expanded weights plus a depth-to-space. A
    grouped ([G,] 3, 3, C, O) kernel expands per group and runs K3-grouped."""
    return depth_to_space2(conv3x3_replicate(x, *up2_conv3_expanded(kernel, bias, x.dtype)))
