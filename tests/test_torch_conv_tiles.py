"""The bf16 K3 kernel's per-launch tile choice (``ops/conv.py::_tile_config``)
at the main path's shapes, and its agreement with what ``csrc/conv3x3.cu``
is built for. Pure Python: runs on the CPU, no card needed."""

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
