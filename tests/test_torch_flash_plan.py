"""The bf16 K2 kernel's launch plan (``ops/attention.py::flash_plan``) at the
main path's shapes, and its agreement with what ``csrc/flash_fwd.cuh`` is
built for; the fp32 kernel's plan (``f32_plan``) at the fp32 paths' shapes
and its agreement with the builds of ``csrc/flash_attn.cu``. Pure Python on
meta tensors (shapes, strides and addresses, no data): runs on the CPU, no
card needed."""

import re
from pathlib import Path

import pytest
import torch

from moge_tpu_torch.ops import _build, attention

SOURCE = Path(attention.__file__).resolve().parent.parent / "csrc" / "flash_fwd.cuh"
F32_SOURCE = SOURCE.with_name("flash_attn.cu")
SMEM_PER_BLOCK = 232_448  # an H100's most dynamic shared memory for one block
SMEM_PER_SM = 233_472     # an H100 SM's shared memory, 1 KB of it reserved per resident block
BF16 = torch.bfloat16

# ViT token counts of the main paths (1369 + cls = 1370, 3600 + cls = 3601,
# MoGe-1's 1200 and 2500 budgets + cls), batch 1 and 8, the heads of ViT-S/B/L
SHAPES = [(n, b, h) for n in (1370, 3601, 1201, 2501) for b in (1, 8) for h in (6, 12, 16)]


def _qkv(b, n, h):
    """q, k, v as the encoder passes them: per-head views of one (B, N, 3, H, 64) projection."""
    qkv = torch.empty(b, n, 3, h, 64, dtype=BF16, device="meta")
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _built():
    """(query rows, key tile, ring slots) the kernel is built with."""
    text = SOURCE.read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", text).group(1)) for name in ("kBr", "kBc", "kStages"))


@pytest.mark.parametrize("n,b,h", SHAPES)
def test_plan_grid_shared_memory_and_tile(n, b, h):
    plan = attention.flash_plan(*_qkv(b, n, h), n)
    assert plan.grid == (-(-n // 64), h, b)
    assert (64, plan.bc, plan.stages) == _built()
    # 8 KB of Q and K and V rings of 32 KB each, + 1 KB to align the swizzle atoms
    assert plan.smem == 64 * 128 + 2 * plan.stages * plan.bc * 128 + 1024 <= SMEM_PER_BLOCK
    assert 3 * (plan.smem + 1024) <= SMEM_PER_SM  # three blocks share an SM (csrc/flash_fwd.cuh's note)


@pytest.mark.parametrize("n,b,h", SHAPES)
def test_plan_tensor_maps_read_the_qkv_views_in_place(n, b, h):
    kv_valid = n - 7  # masked keys: k and v are mapped over kv_valid rows
    plan = attention.flash_plan(*_qkv(b, n, h), kv_valid)
    row = 3 * h * 128  # bytes between tokens of the projection
    for (dims, strides, box), rows, box_rows in zip(plan.maps, (n, kv_valid, kv_valid), (64, plan.bc, plan.bc)):
        assert dims == (64, h, rows, b)
        assert strides == (128, row, n * row)
        assert all(s % 16 == 0 for s in strides)
        assert box == (64, 1, box_rows, 1)


def test_plan_of_contiguous_tensors_and_other_query_lengths():
    """A contiguous (B, Nq, H, 64) q against a longer K/V (Nq != Nkv)."""
    q = torch.empty(2, 77, 3, 64, dtype=BF16, device="meta")
    k = v = torch.empty(2, 200, 3, 64, dtype=BF16, device="meta")
    plan = attention.flash_plan(q, k, v, 150)
    assert plan.grid == (2, 3, 2)
    assert plan.maps[0][:2] == ((64, 3, 77, 2), (128, 384, 77 * 384))
    assert plan.maps[1][:2] == ((64, 3, 150, 2), (128, 384, 200 * 384))


def test_the_plan_is_the_tile_the_kernel_is_built_with():
    assert (attention.Q_ROWS, attention.KEY_TILE, attention.STAGES) == _built()


def test_plan_refuses_a_misaligned_base():
    """A view one element into its storage: TMA needs a 16-byte aligned base."""
    flat = torch.empty(2 * 100 * 3 * 4 * 64 + 1, dtype=BF16, device="meta")
    qkv = flat[1:].view(2, 100, 3, 4, 64)
    with pytest.raises(ValueError, match="TMA"):
        attention.flash_plan(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], 100)


def test_plan_refuses_strides_that_are_not_16_byte_multiples():
    """Heads 65 wide cut to 64: 130-byte rows, not a stride TMA can take."""
    wide = torch.empty(1, 100, 4, 65, dtype=BF16, device="meta")[..., :64]
    with pytest.raises(ValueError, match="TMA"):
        attention.flash_plan(wide, wide, wide, 100)


def test_cpu_tensors_count_no_launch():
    before = _build.read_launches()
    q = torch.randn(1, 5, 2, 64, dtype=BF16)
    attention.flash_attention_fwd(q, q, q)
    assert _build.read_launches() == before


# (B, H, Nq, the build f32_plan takes) on a 132-SM H100: MoGe-1's folder image (2500 tokens), eval
# (3588), the panorama's 12 views (3600), sequence-parallel chunks on 2 and 4 cards (1801, 685,
# 343 queries), the fp32 train step (batch 2 at 1369) and batch 8
F32_SHAPES = [(1, 16, 2501, 3), (1, 16, 3589, 2), (12, 16, 3601, 2), (1, 16, 1801, 2), (1, 16, 685, 2),
              (1, 16, 343, 2), (2, 16, 1370, 3), (1, 16, 1370, 2), (8, 16, 1370, 2)]


def _f32_built():
    """The fp32 kernel's (query rows, keys a tile, {blocks an SM holds: registers a thread})."""
    text = F32_SOURCE.read_text()
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
             for name in ("kWarpRows", "kWarps", "kBc")}
    builds = {int(per_sm): int(regs) for per_sm, regs in
              re.findall(r"per_sm == (\d+)\) return launch_f32_regs<(\d+)>", text)}
    return const["kWarpRows"] * const["kWarps"], const["kBc"], builds


@pytest.mark.parametrize("b,h,nq,per_sm", F32_SHAPES)
def test_f32_plan_at_the_fp32_paths_shapes(b, h, nq, per_sm):
    plan = attention.f32_plan(b, h, nq, 132)
    assert plan == attention.F32Plan(128, per_sm, (-(-nq // 128), h, b))


@pytest.mark.parametrize("b,h,nq,_", F32_SHAPES)
def test_f32_plan_takes_the_build_whose_busiest_sm_finishes_first(b, h, nq, _):
    """Each build's modelled finish (full rounds, then the last by the blocks on its busiest SM)
    by a direct count of the blocks each SM gets, round by round."""
    blocks = b * h * -(-nq // 128)

    def finish(per_sm):
        left, t = blocks, 0.0
        while left:
            now = min(left, per_sm * 132)
            t += attention.F32_ROUNDS[per_sm][-(-now // 132) - 1]
            left -= now
        return t

    plan = attention.f32_plan(b, h, nq, 132)
    assert finish(plan.per_sm) == min(finish(k) for k in attention.F32_ROUNDS)


def test_f32_plan_names_the_builds_the_kernel_has():
    """128 rows a block; each build fits its blocks an SM in an H100's registers and shared memory."""
    rows, keys, builds = _f32_built()
    assert rows == attention.F32_ROWS == 128 and set(builds) == set(attention.F32_ROUNDS) == {2, 3}
    for per_sm, regs in builds.items():
        two_k = per_sm == 2  # the 2-a-SM build gives K^T a second slot
        smem = 4 * (64 * rows + (2 if two_k else 1) * 64 * keys + 2 * keys * 64 + 4 * keys * 32)
        assert per_sm * (smem + 1024) <= SMEM_PER_SM
        assert per_sm * 128 * (-(-regs // 8) * 8) <= 65536


def test_f32_plan_follows_the_sm_count():
    """More SMs fit folder's 320 blocks in one round of 2 an SM."""
    assert attention.f32_plan(1, 16, 2501, 132).per_sm == 3
    assert attention.f32_plan(1, 16, 2501, 160).per_sm == 2  # 320 blocks in one round of 2
