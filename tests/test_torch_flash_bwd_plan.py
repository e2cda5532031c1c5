"""The bf16 flash backward's launch plan (``ops/attention.py::flash_bwd_plan``,
kernels K2b-dq and K2b-dkv) at the train path's shapes, and its agreement
with what ``csrc/flash_attn_bwd.cu`` is built for. Pure Python on meta
tensors (shapes, strides and addresses, no data): runs on the CPU, no card
needed."""

import re
from pathlib import Path

import pytest
import torch

from moge_tpu_torch.ops import _build, attention

SOURCE = Path(attention.__file__).resolve().parent.parent / "csrc" / "flash_attn_bwd.cu"
SMEM_PER_BLOCK = 232_448  # an H100's most dynamic shared memory for one block
SMEM_PER_SM = 233_472     # an H100 SM's shared memory, 1 KB of it reserved per resident block
BF16 = torch.bfloat16

# ViT token counts of the train path (1369 + cls, 3600 + cls) and MoGe-1's
# budgets, batch 1 and 2, the heads of ViT-S/B/L
SHAPES = [(n, b, h) for n in (1370, 3601, 1201, 2501) for b in (1, 2) for h in (6, 12, 16)]


def _qkv(b, n, h, device="meta"):
    """q, k, v as the encoder passes them: per-head views of one (B, N, 3, H, 64) projection."""
    qkv = torch.zeros(b, n, 3, h, 64, dtype=BF16, device=device)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _built():
    """(rows per block, K2b-dq's key tile, K2b-dkv's query tile, ring slots) the kernels are built with."""
    text = SOURCE.read_text()
    body = text[text.index("namespace bwd {"):]
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", body).group(1))
                 for name in ("kRows", "kKeyTile", "kQueryTile", "kStages"))


def test_the_plan_is_the_tile_the_kernels_are_built_with():
    assert (attention.BWD_ROWS, attention.BWD_KEY_TILE, attention.BWD_QUERY_TILE, attention.BWD_STAGES) == _built()


@pytest.mark.parametrize("n,b,h", SHAPES)
def test_plan_grid_shared_memory_and_tiles(n, b, h):
    q, k, v = _qkv(b, n, h)
    plan = attention.flash_bwd_plan(q, k, v, torch.empty_like(q), n)
    rows, kt, qt, stages = _built()
    assert (rows, plan.key_tile, plan.query_tile, plan.stages) == _built()
    assert plan.grid_dq == plan.grid_dkv == (-(-n // rows), h, b)
    # K2b-dq: 8 KB of Q and of dO, K and V rings of 2 x 8 KB, + 1 KB to align the swizzle atoms
    assert plan.smem_dq == 2 * rows * 128 + 2 * stages * kt * 128 + 1024 <= SMEM_PER_BLOCK
    # K2b-dkv: 8 KB of K and of V, Q and dO rings of 2 x 8 KB, each slot with 64 lse and 64 delta
    assert plan.smem_dkv == 2 * rows * 128 + 2 * stages * qt * 128 + stages * 2 * qt * 4 + 1024
    # four K2b-dq and three K2b-dkv blocks share an SM (csrc/flash_attn_bwd.cu's note)
    assert 4 * (plan.smem_dq + 1024) <= SMEM_PER_SM
    assert 3 * (plan.smem_dkv + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("n,b,h", SHAPES)
def test_plan_tensor_maps_read_the_qkv_views_in_place(n, b, h):
    """Both kernels' maps over the qkv views (k and v over kv_valid rows),
    dout contiguous; the outputs are the views of one dqkv, stored in place."""
    kv_valid = n - 7
    q, k, v = _qkv(b, n, h)
    dout = torch.empty(b, n, h, 64, dtype=BF16, device="meta")
    dqkv = torch.empty(b, n, 3, h, 64, dtype=BF16, device="meta")
    outs = (dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2])
    plan = attention.flash_bwd_plan(q, k, v, dout, kv_valid, *outs)
    row = 3 * h * 128  # bytes between tokens of the projection
    for maps, q_rows, kv_rows in ((plan.maps_dq, 64, plan.key_tile), (plan.maps_dkv, plan.query_tile, 64)):
        (qd, qs, qb), (dd, ds, db), (kd, ks, kb), (vd, vs, vb) = maps
        assert qd == dd == (64, h, n, b) and kd == vd == (64, h, kv_valid, b)
        assert qs == ks == vs == (128, row, n * row)
        assert ds == (128, h * 128, n * h * 128)
        assert qb == db == (64, 1, q_rows, 1) and kb == vb == (64, 1, kv_rows, 1)
    assert plan.stores == tuple((n * 3 * h * 64, 3 * h * 64, 64) for _ in outs)


def test_plan_of_contiguous_tensors_and_other_query_lengths():
    """A contiguous (B, Nq, H, 64) q against a longer K/V (Nq != Nkv): dq's
    grid follows the queries, dkv's the keys."""
    q = torch.empty(2, 77, 3, 64, dtype=BF16, device="meta")
    k = v = torch.empty(2, 200, 3, 64, dtype=BF16, device="meta")
    plan = attention.flash_bwd_plan(q, k, v, torch.empty_like(q), 150)
    assert plan.grid_dq == (2, 3, 2) and plan.grid_dkv == (4, 3, 2)
    assert plan.maps_dq[0][:2] == ((64, 3, 77, 2), (128, 384, 77 * 384))
    assert plan.maps_dkv[2][:2] == ((64, 3, 150, 2), (128, 384, 200 * 384))


def test_plan_refuses_a_misaligned_base():
    """A view one element into its storage: TMA needs a 16-byte aligned base."""
    flat = torch.empty(2 * 100 * 3 * 4 * 64 + 1, dtype=BF16, device="meta")
    qkv = flat[1:].view(2, 100, 3, 4, 64)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    with pytest.raises(ValueError, match="TMA"):
        attention.flash_bwd_plan(q, k, v, torch.empty(2, 100, 4, 64, dtype=BF16, device="meta"), 100)
    good = _qkv(2, 100, 4)
    with pytest.raises(ValueError, match="TMA"):  # dout too is read by TMA
        attention.flash_bwd_plan(*good, q, 100)


def test_plan_refuses_strides_that_are_not_16_byte_multiples():
    """Heads 65 wide cut to 64: 130-byte rows, not a stride TMA can take."""
    wide = torch.empty(1, 100, 4, 65, dtype=BF16, device="meta")[..., :64]
    with pytest.raises(ValueError, match="TMA"):
        attention.flash_bwd_plan(wide, wide, wide, wide, 100)


def test_plan_refuses_an_output_it_cannot_store_in_pairs():
    """The kernels store bf16 pairs: an output one element into its storage is refused."""
    q, k, v = _qkv(1, 100, 4)
    flat = torch.empty(100 * 4 * 64 + 1, dtype=BF16, device="meta")
    with pytest.raises(ValueError, match="pairs"):
        attention.flash_bwd_plan(q, k, v, torch.empty_like(q), 100, flat[1:].view(1, 100, 4, 64))


def test_cpu_tensors_count_no_launch():
    before = _build.read_launches()
    q, k, v = _qkv(1, 5, 2, device="cpu")
    out, lse = attention.flash_attention_fwd(q, k, v)
    attention.flash_attention_bwd(q, k, v, out, lse, torch.ones_like(out))
    assert _build.read_launches() == before
