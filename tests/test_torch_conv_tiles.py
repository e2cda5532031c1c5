"""The K3 kernels' per-launch tile choice at the main path's shapes, and its
agreement with what ``csrc/conv3x3.cu`` is built for: the bf16 kernel's
(``ops/conv.py::_tile_config``) and the fp32 kernel's (``_f32_tile``, at
MoGe-1's folder shapes). Pure Python: runs on the CPU, no card needed."""

import math
import re
from pathlib import Path

import pytest

from moge_tpu_torch.models.multihead import FOLD_PAD
from moge_tpu_torch.ops import _build, conv

SOURCE = Path(conv.__file__).resolve().parent.parent / "csrc" / "conv3x3.cu"
SMS = 132  # an H100 SXM's streaming multiprocessors


def _grid(tokens):
    """The 518x518 token grid side: 37 at 1369 tokens, 60 at 3600."""
    return math.isqrt(tokens)


def _main_shapes(g):
    """(H, C, O) of every 3x3 conv of a moge-2-vitl-normal ``infer`` with
    sequential heads on a g x g token grid (models/modules.py ConvStack: the
    three levels at 2g, 4g, 8g; the neck's bilinear-up2 conv at 8g, 4
    parities x 32; the points and normal heads' up2 conv with the 1x1 folded
    in, 4 x 3, and the mask head's, 4 x 1)."""
    return [(2 * g, 256, 256), (4 * g, 128, 128), (8 * g, 64, 64), (8 * g, 64, 128), (8 * g, 64, 12),
            (8 * g, 64, 4)]


def _grouped_shapes(g):
    """(H, C, O) of the batched heads' K3-grouped convs (G = 3): the levels,
    and the up2 conv with the fold padded to ``FOLD_PAD`` channels."""
    return [(2 * g, 256, 256), (4 * g, 128, 128), (8 * g, 64, 64), (8 * g, 64, 4 * FOLD_PAD)]


def _built_tiles():
    """(bm, bn, copy) of every bf16 instantiation the C dispatch lists."""
    text = SOURCE.read_text()
    widths = [int(w) for w in re.findall(r"MOGE_CONV_CASE\(BM_, (\d+), VW_\)", text)]
    tiles = {(int(bm), bn, int(vw)) for bm, vw in re.findall(r"^\s*MOGE_CONV_WIDTHS\((\d+), (\d+)\)", text, re.M)
             for bn in widths}
    tiles |= {tuple(int(v) for v in t) for t in re.findall(r"^\s*MOGE_CONV_CASE\((\d+), (\d+), (\d+)\)", text, re.M)}
    return tiles


@pytest.mark.parametrize("tokens", [1369, 3600])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("shape", range(6))
def test_main_path_shapes_take_the_pipelined_wgmma_path(tokens, batch, shape):
    h, c, o = _main_shapes(_grid(tokens))[shape]
    tile = conv._tile_config(1, batch, h, h, c, o, SMS)
    assert tile.variant in conv.PIPELINED
    assert tile.copy == (16 if o % 8 == 0 else 8)  # the heads' 12 and 4 channels: 8-byte copies
    assert (tile.bm, tile.bn, tile.copy) in _built_tiles()


@pytest.mark.parametrize("tokens", [1369, 3600])
@pytest.mark.parametrize("b0", [1, 8])
@pytest.mark.parametrize("shape", range(4))
def test_grouped_shapes_take_the_pipelined_wgmma_path(tokens, b0, shape):
    h, c, o = _grouped_shapes(_grid(tokens))[shape]
    tile = conv._tile_config(3, b0, h, h, c, o, SMS)
    assert tile.variant == "wgmma_tma_cp16"
    assert (tile.bm, tile.bn, tile.copy) in _built_tiles()


def test_the_smallest_level_fills_the_card_at_batch_1():
    """74^2 at batch 1 (5476 pixels, 256 -> 256): at least one block per SM."""
    tile = conv._tile_config(1, 1, 74, 74, 256, 256, SMS)
    assert tile.blocks(1, 1, 74, 74, 256) >= SMS


@pytest.mark.parametrize("o", [1, 4, 8, 12, 16, 20, 32, 33, 64, 70, 96, 128, 129, 256])
def test_n_tile_is_the_narrowest_width_that_holds_o(o):
    bn = conv._tile_config(1, 1, 40, 40, 64, o, SMS).bn
    if o <= max(conv.N_TILES):
        assert o <= bn == min(n for n in conv.N_TILES if n >= o)
    else:  # wider outputs split into N tiles of the widest width
        assert bn == max(conv.N_TILES)


@pytest.mark.parametrize("c,o,copy", [(64, 64, 16), (24, 20, 8), (12, 12, 8), (130, 70, 4), (6, 10, 4),
                                      (7, 9, 2), (64, 9, 2), (9, 64, 2), (1, 1, 2)])
def test_copy_width_follows_the_channel_alignment(c, o, copy):
    """16 bytes where C and O are multiples of 8, else 8 or 4; an odd C or O
    takes the generic loader."""
    tile = conv._tile_config(1, 1, 9, 13, c, o, SMS)
    assert tile.copy == copy
    assert tile.variant == ("wgmma_generic" if copy == 2 else conv.PIPELINED[(16, 8, 4).index(copy)])
    assert (tile.bm, tile.bn, tile.copy) in _built_tiles()


@pytest.mark.parametrize("align,copy", [(16, 16), (8, 8), (4, 4), (2, 2)])
def test_misaligned_pointers_narrow_the_copies(align, copy):
    assert conv._tile_config(1, 1, 74, 74, 256, 256, SMS, align).copy == copy


def test_every_tile_the_config_returns_is_built():
    built = _built_tiles()
    assert len(built) == 18
    for g in (1, 3):
        for b0 in (1, 2, 8):
            for h in (1, 7, 37, 74, 120, 296, 480):
                for c, o in ((64, 64), (256, 256), (128, 128), (64, 128), (64, 12), (24, 20), (130, 70), (7, 9)):
                    tile = conv._tile_config(g, b0, h, h, c, o, SMS)
                    assert (tile.bm, tile.bn, tile.copy) in built, (g, b0, h, c, o, tile)


@pytest.mark.parametrize("sms,bm", [(66, 128), (132, 128), (175, 128), (176, 64), (1000, 64)])
def test_wide_tile_needs_four_blocks_per_sm_of_the_card(sms, bm):
    """296^2 64 -> 64 at batch 1 has 37 x 19 = 703 patches of 8 x 16 pixels:
    the 128-pixel tile while that is at least 4 blocks per SM of the card."""
    assert conv._tile_config(1, 1, 296, 296, 64, 64, sms).bm == bm


def test_cpu_tensors_count_no_launch():
    import torch

    before = _build.read_launches()
    x = torch.randn(1, 5, 6, 8, dtype=torch.bfloat16)
    conv.conv3x3_replicate(x, torch.randn(3, 3, 8, 4, dtype=torch.bfloat16), torch.zeros(4))
    assert _build.read_launches() == before


# (H, W, C, O) of every 3x3 conv of MoGe-1 moge-vitl's fp32 ``infer`` on a
# 480x640 image at 2500 tokens (a 43 x 57 token grid, the network input
# 606 x 808): per upsample stage (86 x 114, 172 x 228, 344 x 456) the conv
# after the transposed conv, the res blocks' convs into and out of the
# doubled width; the two output heads' first conv over the features and the
# UV channels (64 + 2 -> 32)
MOGE1_SHAPES = [(86, 114, 256, 256), (86, 114, 256, 512), (86, 114, 512, 256),
                (172, 228, 128, 128), (172, 228, 128, 256), (172, 228, 256, 128),
                (344, 456, 64, 64), (344, 456, 64, 128), (344, 456, 128, 64), (606, 808, 66, 32)]


def _built_f32_tiles():
    """(bn, chunk, copy) of every fp32 build the C dispatch lists."""
    text = SOURCE.read_text()
    widths = [int(w) for w in re.findall(r"MOGE_CONV_F32\((\d+), KC_, CW_\)", text)]
    return {(bn, int(kc), int(cw)) for kc, cw in re.findall(r"^\s*MOGE_CONV_F32_WIDTHS\((\d+), (\d+)\)", text, re.M)
            for bn in widths}


def _f32_builds(c):
    """Every build of the fp32 kernel a C-channel input can take."""
    plan = conv._f32_tile(1, 1, 64, 64, c, 64, SMS)
    return [conv.F32Tile(conv.F32_OUTPUTS // bn, bn, plan.copy, plan.chunk) for bn in conv.F32_N_TILES]


@pytest.mark.parametrize("h,w,c,o", MOGE1_SHAPES)
def test_moge1_shapes_take_the_tiled_fp32_kernel(h, w, c, o):
    tile = conv._f32_tile(1, 1, h, w, c, o, SMS)
    assert tile.variant == "fp32"
    assert (tile.bn, tile.chunk, tile.copy) in _built_f32_tiles()
    assert tile.bm * tile.bn == conv.F32_OUTPUTS and tile.patch[0] * tile.patch[1] == tile.bm


@pytest.mark.parametrize("h,o,bn", [(606, 32, 32), (606, 12, 32), (606, 4, 32), (344, 64, 64), (344, 128, 128),
                                    (172, 256, 128), (344, 512, 128)])
def test_fp32_n_width_follows_o_where_the_grid_is_large(h, o, bn):
    """Many rounds of blocks: the narrowest build that holds O (the heads'
    32, MoGe-2's up2 parity forms 4 x 3 and 4 x 1), 128 above it."""
    assert conv._f32_tile(1, 1, h, h * 4 // 3, 64, o, SMS).bn == bn


@pytest.mark.parametrize("c,chunk,copy", [(66, 8, 8), (64, 16, 16), (256, 16, 16), (24, 8, 16), (130, 8, 8),
                                          (2, 8, 8), (20, 8, 16)])
def test_fp32_chunk_pads_c_the_least(c, chunk, copy):
    """16 channels a K step where that divides C, else 8: folder's heads (C =
    64 + 2) pad 66 to 72, not to 80 (16) or 96 (the generic kernel's 32)."""
    tile = conv._f32_tile(1, 1, 606, 808, c, 32, SMS)
    assert (tile.chunk, tile.copy) == (chunk, copy)
    assert (tile.bn, tile.chunk, tile.copy) in _built_f32_tiles()
    if c == 66:
        assert -(-c // tile.chunk) * tile.chunk == 72


@pytest.mark.parametrize("h,w,c,o", [s for s in MOGE1_SHAPES if s[0] == 86])
def test_fp32_plan_finishes_first_at_the_smallest_level(h, w, c, o):
    """86 x 114 (9,804 pixels) on 132 SMs: of the builds, the launch whose
    busiest SM finishes first, by whole rounds of two blocks an SM and the
    last round's load; 256 -> 256 and 512 -> 256 in one round (176 blocks),
    256 -> 512 in one full round and one of one block an SM (352)."""
    tile = conv._f32_tile(1, 1, h, w, c, o, SMS)
    finishes = [conv._f32_finish(t.blocks(1, 1, h, w, o), SMS) for t in _f32_builds(c)]
    assert conv._f32_finish(tile.blocks(1, 1, h, w, o), SMS) == min(finishes)
    assert tile.blocks(1, 1, h, w, o) == (352 if o == 512 else 176)
    assert conv._f32_finish(tile.blocks(1, 1, h, w, o), SMS) == \
        (conv.F32_ROUNDS[-1] + conv.F32_ROUNDS[0] if o == 512 else conv.F32_ROUNDS[-1])


def test_fp32_rounds_follow_the_sm_count():
    """Whole rounds of ``F32_PER_SM`` blocks an SM; a last round weighed by
    the blocks it leaves on the busiest SM."""
    per_round = conv.F32_PER_SM * SMS
    assert conv._f32_finish(per_round, SMS) == conv.F32_ROUNDS[-1]
    assert conv._f32_finish(3 * per_round, SMS) == 3 * conv.F32_ROUNDS[-1]
    assert conv._f32_finish(per_round + 1, SMS) == conv.F32_ROUNDS[-1] + conv.F32_ROUNDS[0]
    assert conv._f32_finish(per_round + SMS + 1, SMS) == 2 * conv.F32_ROUNDS[-1]
    assert conv._f32_finish(SMS, SMS) == conv.F32_ROUNDS[0]


@pytest.mark.parametrize("c,o,align", [(7, 20, 16), (24, 9, 16), (24, 18, 16), (1, 1, 16), (24, 20, 8), (24, 20, 4),
                                       (66, 32, 8)])
def test_fp32_generic_route(c, o, align):
    """An odd C, an O not a multiple of 4 or a pointer not 16-byte aligned
    takes the generic kernel, counted under ``fp32_generic``."""
    tile = conv._f32_tile(1, 1, 9, 13, c, o, SMS, align)
    assert tile == conv.F32_GENERIC and tile.variant == "fp32_generic"
    assert tile.variant in conv.VARIANTS


@pytest.mark.parametrize("g,b0", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_fp32_blocks_cover_every_pixel_once(g, b0):
    """The grid: G x B0 x patches x N tiles, each patch whole inside the
    padded image."""
    for h, w, c, o in MOGE1_SHAPES + [(9, 13, 24, 20), (37, 53, 64, 64), (1, 1, 8, 12)]:
        tile = conv._f32_tile(g, b0, h, w, c, o, SMS)
        ph, pw = tile.patch
        patches = -(-h // ph) * -(-w // pw)
        assert tile.blocks(g, b0, h, w, o) == g * b0 * patches * -(-o // tile.bn)
        assert patches * tile.bm >= h * w
        assert (-(-h // ph) - 1) * ph < h and (-(-w // pw) - 1) * pw < w
