"""K1's launch plan (``ops/norm.py::ln_plan``) and its agreement with what
``csrc/layernorm.cu`` is built for; and T6's tiles
(``tools/exp_dense_pallas.py::VARIANTS["bf16"]``) against what
``csrc/exp_dense.cu`` is built for. Pure Python: runs on the CPU, no card
needed."""

import re
from pathlib import Path

import pytest
import torch

from moge_tpu_torch.models.dinov2 import VIT_ARCHS
from moge_tpu_torch.ops import _build, norm
from moge_tpu_torch.tools import exp_dense_pallas as dense

CSRC = Path(norm.__file__).resolve().parent.parent / "csrc"
SMS = 132  # an H100 SXM's streaming multiprocessors
DTYPES = {torch.bfloat16: 2, torch.float32: 4}
# the ViT-L rows of a 518x518 image at 1369 and 3600 tokens (with the class token), batch 1 and 8
MAIN_PATH_ROWS = (1370, 3601, 8 * 1370, 8 * 3601)


def _built_ln_cases():
    """(variant, bytes per element, accesses per lane) of every instantiation the C dispatch lists."""
    text = (CSRC / "layernorm.cu").read_text()
    names = {"kVec16": "vec16", "kScalar": "scalar"}
    elems = {"kBFloat16": 2, "kFloat32": 4}
    return {(names[v], elems[d], int(n)) for v, d, n in
            re.findall(r"^\s*MOGE_LN_CASE\((\w+), (\w+), (\d+)\)", text, re.M)}


def _built_bf16_tiles():
    text = (CSRC / "exp_dense.cu").read_text()
    return {100 * int(rb) + int(cpt) for rb, cpt in re.findall(r"^\s*MOGE_BF16_CASE\((\d+), (\d+)\)", text, re.M)}


def test_vectors_list_is_what_the_library_is_built_for():
    built = _built_ln_cases()
    assert built == {(v, e, n) for (v, e), ns in norm.VECTORS.items() for n in ns}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("aligned", [True, False])
def test_every_d_has_a_built_case_that_holds_the_row(dtype, aligned):
    built = _built_ln_cases()
    for d in range(1, 2049):
        plan = norm.ln_plan(7, d, dtype, 0 if aligned else 2, SMS)
        elem = DTYPES[dtype]
        per_access = 16 if plan.variant == "vec16" else elem
        assert (plan.variant, elem, plan.vectors) in built
        assert plan.vectors * 32 * per_access >= d * elem  # the row fits
        smaller = [n for n in norm.VECTORS[plan.variant, elem] if n < plan.vectors]
        assert all(n * 32 * per_access < d * elem for n in smaller)  # the smallest built case that fits


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("backbone", sorted(VIT_ARCHS))
@pytest.mark.parametrize("rows", MAIN_PATH_ROWS)
def test_main_path_widths_take_vec16(dtype, backbone, rows):
    """Every ViT's width (ViT-S 384 ... ViT-G 1536; the tiny test config's
    192 too) on an aligned row runs 16-byte accesses."""
    d = VIT_ARCHS[backbone].embed_dim
    plan = norm.ln_plan(rows, d, dtype, 256, SMS)
    assert plan.variant == "vec16"
    assert plan.vectors * 32 * 16 >= d * DTYPES[dtype]


@pytest.mark.parametrize("d", [192, 384, 768, 1024, 1536, 2048])
def test_aligned_widths_up_to_2048_take_vec16(d):
    for dtype in DTYPES:
        assert norm.ln_plan(1, d, dtype, 0, SMS).variant == "vec16"


@pytest.mark.parametrize("ptr", [2, 4, 8, 12, 1026])
def test_misaligned_pointers_take_scalar(ptr):
    for dtype in DTYPES:
        assert norm.ln_plan(1370, 1024, dtype, ptr, SMS).variant == "scalar"


@pytest.mark.parametrize("d,dtype", [(1001, torch.bfloat16), (1002, torch.bfloat16), (1002, torch.float32),
                                     (7, torch.float32), (1004, torch.bfloat16)])
def test_d_not_a_multiple_of_16_bytes_takes_scalar(d, dtype):
    assert norm.ln_plan(64, d, dtype, 0, SMS).variant == "scalar"


def test_d_1000_is_a_multiple_of_16_bytes():
    for dtype in DTYPES:
        assert norm.ln_plan(5, 1000, dtype, 0, SMS).variant == "vec16"


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 37, 1369, 1370, 2112, 2113, 3601, 8 * 1370, 28808, 10 ** 6])
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_grid_covers_every_row_within_rows_per_warp(m, sms):
    plan = norm.ln_plan(m, 1024, torch.bfloat16, 0, sms)
    warps = plan.grid * norm.WARPS
    assert plan.block == norm.WARPS * 32
    assert plan.grid <= max(sms * norm.BLOCKS_PER_SM, -(-m // norm.WARPS))
    assert -(-m // warps) <= plan.rows_per_warp  # a warp walks rows strided by all warps
    assert (plan.grid - 1) * norm.WARPS * plan.rows_per_warp < m  # no block without a row


def test_grid_choices_at_the_main_path_rows():
    """M = 1370 (batch 1, 1369 tokens): a warp per row, 343 blocks on 132
    SMs; 3601: two rows a warp; 28808 (batch 8, 3600 tokens): 14 rows a
    warp, about four blocks an SM."""
    assert norm.ln_plan(1370, 1024, torch.bfloat16, 0, SMS)[2:4] == (1, 343)
    assert norm.ln_plan(3601, 1024, torch.bfloat16, 0, SMS)[2:4] == (2, 451)
    assert norm.ln_plan(28808, 1024, torch.bfloat16, 0, SMS)[2:4] == (14, 515)
    assert norm.ln_plan(1, 1024, torch.bfloat16, 0, SMS)[2:4] == (1, 1)


def test_plan_raises_on_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        norm.ln_plan(3, 4096, torch.float32, 0, SMS)
    with pytest.raises(ValueError):
        norm.ln_plan(3, 0, torch.float32, 0, SMS)
    with pytest.raises(TypeError):
        norm.ln_plan(3, 64, torch.float16, 0, SMS)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    x, s, b = torch.randn(5, 64), torch.randn(64), torch.randn(64)
    before = _build.read_launches()
    assert torch.equal(norm.layer_norm_fp32(x, s, b), norm.layer_norm_plain(x, s, b))
    assert _build.read_launches() == before


def test_bf16_tiles_are_what_the_library_is_built_for():
    code, default, tiles = dense.VARIANTS["bf16"]
    assert set(tiles) == _built_bf16_tiles()
    assert default in tiles


@pytest.mark.parametrize("tile", dense.VARIANTS["bf16"][2])
def test_bf16_tiles_fit_the_block(tile):
    """100 * rows per block + m16 candidate tiles per warp: the 128 threads
    split evenly over the rows, whole warps to a row."""
    rb, mt = divmod(tile, 100)
    assert 128 % rb == 0 and (128 // rb) % 32 == 0 and 1 <= mt <= 8
