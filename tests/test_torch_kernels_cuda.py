"""Kernels K1-K4 (with the flash backward K2b-dq/K2b-dkv and the grouped conv
K3-grouped) on the card against their plain versions, in fp32 and bf16, at
small ragged shapes and at the main path's K3 shapes (one case per copy
variant, counted; the fp32 K3 also at MoGe-1's folder shapes), and the tiny
MoGe-2 decode (sequential and batched heads), the tiny MoGe-1 forward and
the MoGe-2 gradient on the card against the CPU, the sorted truncated-align
forms and the bitonic network on the card against the CPU and the stable
sort, the ported TPU probes T1-T6
against their plain versions, and the camera solve K5 against its plain
version on the card (one launch, no host synchronisation). Needs
a CUDA GPU and
nvcc (the kernels have no CPU mode); skipped elsewhere. On a GPU host:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX, which a GPU host need
not have. This file imports no JAX.)
"""

from collections import Counter

import numpy as np
import pytest
import torch

from moge_tpu_torch.ops import _build, alignment, attention, bitonic, conv, norm, solvers
from torch_tiny_config import TINY_CONFIG, camera_point_maps

pytestmark = pytest.mark.cuda

FP32_TOL = 1e-5   # fp32 kernel vs fp32 plain version: summation order only
K2_BF16_ABS = 2e-2
K3_BF16_REL = 1e-2
K2B_FP32_REL = 1e-4  # fp32 backward vs autograd of the plain version: summation order
K2B_BF16_REL = 3e-2  # P and dS rounded to bf16 before their products, as on the TPU
K4_REL = 2e-5        # fp32 sums of up to ~1.7k terms in another order (and fma)
# K5 against the plain solve on the card: |focal ratio - 1| and |shift
# difference| / mean |z|. Both are fp32 30-step LM solves whose sums run in
# another order: on an H100 the 18 cases below read up to 9.4e-6 (focal) and
# 1.05e-5 (shift), both at batch 8 with a mask; in a CPU emulation each
# order lies up to 1.3e-5 from a float64 solve of the same samples
SOLVE_REL = 2e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _counts() -> Counter:
    """A copy of the launch registry, (kernel, variant) -> launches."""
    return Counter(_build.LAUNCHES)


def _moved(before: Counter) -> dict:
    """The launches counted since ``before``, by (kernel, variant)."""
    return dict(Counter(_build.LAUNCHES) - before)


def _by_kernel(before: Counter) -> Counter:
    """The launches counted since ``before``, by kernel (summed over its variants)."""
    moved = Counter()
    for (kernel, _), n in (Counter(_build.LAUNCHES) - before).items():
        moved[kernel] += n
    return moved


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _check_layer_norm(x, s, b, variant, slack=0.0):
    """K1 against its plain version, the launch counted under ``variant``:
    fp32 to FP32_TOL; bf16 within one bf16 ulp of the plain version's fp32
    result (one rounding), plus ``slack`` absolute."""
    before = _counts()
    got = norm.layer_norm_fp32(x, s, b).float()
    assert _moved(before) == {("layer_norm", variant): 1}
    want = norm.layer_norm_plain(x.float(), s, b)
    if x.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    else:  # one bf16 rounding of the fp32 result
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
        assert bool(((got - want).abs() <= ulp + slack).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d", [(37, 192), (5, 1000), (130, 2048)])
def test_layer_norm(dev, dtype, m, d):
    """Aligned rows with D a multiple of 16 bytes (D = 1000 too): the vec16 variant."""
    g = _gen(dev, m + d)
    x = (torch.randn(m, d, device=dev, generator=g) * 3 + 1).to(dtype)
    s, b = torch.randn(d, device=dev, generator=g), torch.randn(d, device=dev, generator=g)
    _check_layer_norm(x, s, b, "vec16")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [192, 384, 1024, 1536, 2048])
@pytest.mark.parametrize("m", [1, 1370, 28808])
def test_layer_norm_vit_widths(dev, dtype, m, d):
    """The ViT widths at one row, the ViT-L rows at batch 1 and batch 8 at
    3600 tokens: the vec16 variant. bf16: one ulp of the plain version's
    fp32 result plus FP32_TOL, the fp32 results' own difference (statistics
    summed in another order), which one ulp of an output within ~1e-5 of 0
    cannot hold: millions of outputs hold a few such."""
    g = _gen(dev, m + d)
    x = (torch.randn(m, d, device=dev, generator=g) * 3 + 1).to(dtype)
    s, b = torch.randn(d, device=dev, generator=g), torch.randn(d, device=dev, generator=g)
    _check_layer_norm(x, s, b, "vec16", FP32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,offset", [(1370, 1024, 1), (37, 192, 1), (130, 2048, 3), (5, 1002, 0),
                                        (1370, 1001, 0)])
def test_layer_norm_scalar_variant(dev, dtype, m, d, offset):
    """A contiguous view with a storage offset (not 16-byte aligned), or D
    not a multiple of 16 bytes: the scalar variant (bf16 as in
    ``test_layer_norm_vit_widths``)."""
    g = _gen(dev, m + d + offset)
    x = (torch.randn(m * d + offset, device=dev, generator=g) * 3 + 1).to(dtype)[offset:].view(m, d)
    s, b = torch.randn(d, device=dev, generator=g), torch.randn(d, device=dev, generator=g)
    _check_layer_norm(x, s, b, "scalar", FP32_TOL)


def test_layer_norm_launches_directly_without_grad_and_through_autograd_with_it(dev):
    """No gradient needed (no_grad, or no input requiring one): the kernel
    without the autograd Function; else the Function, whose backward is the
    plain version's VJP."""
    g = _gen(dev, 5)
    x = torch.randn(64, 384, device=dev, generator=g).to(torch.bfloat16)
    s, b = torch.randn(384, device=dev, generator=g), torch.randn(384, device=dev, generator=g)
    assert norm.layer_norm_fp32(x, s, b).grad_fn is None
    s.requires_grad_()
    with torch.no_grad():
        assert norm.layer_norm_fp32(x, s, b).grad_fn is None
    y = norm.layer_norm_fp32(x, s, b)
    assert y.grad_fn is not None
    (gs,) = torch.autograd.grad(y.float().sum(), s)
    (want,) = torch.autograd.grad(norm.layer_norm_plain(x, s, b).float().sum(), s)
    torch.testing.assert_close(gs, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nkv,h,kv_valid", [
    (2, 77, 77, 3, None), (1, 130, 200, 2, 150), (1, 64, 64, 1, 1),
    # kv_valid on and around the edges of the bf16 kernel's 128-key tiles and inside one, one key, Nq != Nkv
    (2, 300, 300, 3, 63), (2, 300, 300, 3, 64), (2, 300, 300, 3, 65), (2, 300, 300, 3, 127), (2, 300, 300, 3, 128),
    (2, 300, 300, 3, 129), (1, 300, 300, 2, 1), (1, 257, 401, 2, 385),
    # the main path's widths: batch 8 at 1370 tokens, 3601 tokens
    (8, 1370, 1370, 16, None), (1, 3601, 3601, 16, None)])
def test_flash_attention(dev, dtype, b, nq, nkv, h, kv_valid):
    g = _gen(dev, nq * nkv)
    qkv = torch.randn(b, nkv, 3, h, 64, device=dev, generator=g).to(dtype)
    q = (torch.randn(b, nq, h, 64, device=dev, generator=g) * 2).to(dtype)
    k, v = qkv[:, :, 1], qkv[:, :, 2]  # strided views, as the encoder passes them
    before = _counts()
    out, lse = attention.flash_attention_fwd(q, k, v, kv_valid)
    variant = "wgmma" if dtype == torch.bfloat16 else "fp32"
    assert _moved(before) == {("flash_attention", variant): 1}
    want, want_lse = attention.attention_plain(q.float(), k.float(), v.float(), kv_valid, return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=FP32_TOL, atol=1e-4)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=FP32_TOL, atol=FP32_TOL)
    else:
        assert (out.float() - want).abs().max().item() <= K2_BF16_ABS


def _f32_build(monkeypatch, per_sm):
    """Every fp32 K2 launch takes the build that lets ``per_sm`` blocks share an SM (3: one K^T
    slot, two barriers a tile; 2: two slots, one barrier)."""
    plan = attention.f32_plan
    monkeypatch.setattr(attention, "f32_plan", lambda B, H, Nq, sms: plan(B, H, Nq, sms)._replace(per_sm=per_sm))


def _check_f32(q, k, v, kv_valid):
    """fp32 K2 (one launch, counted under fp32) against the plain version: out and lse at
    test_flash_attention's tolerances."""
    before = _counts()
    out, lse = attention.flash_attention_fwd(q, k, v, kv_valid)
    assert _moved(before) == {("flash_attention", "fp32"): 1}
    want, want_lse = attention.attention_plain(q, k, v, kv_valid, return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=FP32_TOL, atol=1e-4)
    torch.testing.assert_close(out, want, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("per_sm", [3, 2])
@pytest.mark.parametrize("nq", [127, 128, 129, 257])
@pytest.mark.parametrize("kv_valid", [1, 31, 32, 33, 63, 64, 65])
def test_flash_attention_fp32_tile_edges(dev, monkeypatch, per_sm, nq, kv_valid):
    """The fp32 kernel with Nq on and around its 128-row query tiles and kv_valid on and around
    its 32-key tiles (one key; whole key tiles past kv_valid, never read), in both builds; q a
    contiguous tensor, k and v strided views of a (B, N, 3, H, 64) projection."""
    g = _gen(dev, 1000 * nq + kv_valid)
    qkv = torch.randn(2, 130, 3, 3, 64, device=dev, generator=g)
    q = torch.randn(2, nq, 3, 64, device=dev, generator=g) * 2
    _f32_build(monkeypatch, per_sm)
    _check_f32(q, qkv[:, :, 1], qkv[:, :, 2], kv_valid)


@pytest.mark.parametrize("per_sm", [3, 2])
def test_flash_attention_fp32_first_keys_that_vanish(dev, monkeypatch, per_sm):
    """Rows whose first two key tiles score about -112 and whose later keys about 0 +- 2: the
    running max starts on keys whose probabilities then underflow to 0 (the rescale by
    exp(m_old - m_new) is 0), against the plain softmax of the same logits; Nq past the last
    query tile's rows."""
    g = _gen(dev, 17 + per_sm)
    k = torch.randn(1, 200, 2, 64, device=dev, generator=g)
    k[:, :64] = -7 + 0.1 * k[:, :64]
    v = torch.randn(1, 200, 2, 64, device=dev, generator=g)
    q = 2 + 0.1 * torch.randn(1, 150, 2, 64, device=dev, generator=g)
    _f32_build(monkeypatch, per_sm)
    _check_f32(q, k, v, 180)


@pytest.mark.parametrize("b,nq,nkv,h,kv_valid", [
    # MoGe-1's folder image (2500 tokens + cls), a sequence-parallel chunk on 2 cards (Nq != Nkv,
    # kv_valid < Nkv), B = 2 at 1370 tokens and a B = 2 chunk on 2 cards
    (1, 2501, 2501, 16, 2501), (1, 1801, 3602, 16, 3601), (2, 1370, 1370, 16, 1370), (2, 685, 1370, 16, 1369)])
def test_flash_attention_fp32_main_path_shapes(dev, b, nq, nkv, h, kv_valid):
    """The fp32 kernel at the build its plan takes, q, k and v strided views of one
    (B, N, 3, H, 64) projection (q its first Nq tokens), out and lse against the plain version."""
    g = _gen(dev, nq + nkv)
    qkv = torch.randn(b, nkv, 3, h, 64, device=dev, generator=g)
    _check_f32(qkv[:, :nq, 0] * 2, qkv[:, :, 1], qkv[:, :, 2], kv_valid)


@pytest.mark.parametrize("per_sm", [3, 2])
@pytest.mark.parametrize("b,n,h,kv_valid", [(1, 300, 2, 257), (2, 129, 3, None), (1, 2501, 2, None)])
def test_flash_attention_fp32_backward_reads_either_builds_lse(dev, monkeypatch, per_sm, b, n, h, kv_valid):
    """fp32 K2b-dq and K2b-dkv recompute the probabilities from the lse of the fp32 forward:
    gradients through flash_attention_qkv, each build of the forward, against autograd through
    the plain version (K2B_FP32_REL, as test_flash_attention_backward holds fp32)."""
    g = _gen(dev, 5 * n + h + per_sm)
    qkv = torch.randn(b, n, 3, h, 64, device=dev, generator=g).requires_grad_()
    dout = torch.randn(b, n, h, 64, device=dev, generator=g)
    _f32_build(monkeypatch, per_sm)
    before = _counts()
    (got,) = torch.autograd.grad(attention.flash_attention_qkv(qkv, kv_valid), qkv, dout)
    assert _moved(before).get(("flash_attention", "fp32")) == 1
    ref = qkv.detach().requires_grad_()
    (want,) = torch.autograd.grad(attention.attention_plain(ref[:, :, 0], ref[:, :, 1], ref[:, :, 2], kv_valid),
                                  ref, dout)
    tol = K2B_FP32_REL * want.abs().max().item()
    for i, name in enumerate(("dq", "dk", "dv")):
        assert (got[:, :, i] - want[:, :, i]).abs().max().item() <= tol, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,relu,use_res", [
    ((2, 7, 5, 24, 20), True, True), ((1, 1, 1, 8, 12), False, False),
    ((1, 37, 53, 64, 64), True, False), ((1, 9, 70, 130, 70), False, True)])
def test_conv3x3(dev, dtype, shape, relu, use_res):
    b, h, w, c, o = shape
    g = _gen(dev, sum(shape))
    x = torch.randn(b, h, w, c, device=dev, generator=g).to(dtype)
    k = (torch.randn(3, 3, c, o, device=dev, generator=g) * (9 * c) ** -0.5).to(dtype)
    bias = torch.randn(o, device=dev, generator=g)
    res = torch.randn(b, h, w, o, device=dev, generator=g).to(dtype) if use_res else None
    got = conv.conv3x3_replicate(x, k, bias, res, relu).float()
    want = conv.conv3x3_plain(x.float(), k.float(), bias, None if res is None else res.float(), relu)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=FP32_TOL, atol=FP32_TOL * want.abs().max().item())
    else:
        assert (got - want).abs().max().item() <= K3_BF16_REL * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,relu,use_res", [
    ((3, 1, 7, 5, 24, 20), True, True), ((3, 2, 1, 1, 8, 12), False, False),
    ((3, 2, 37, 53, 64, 64), True, False), ((2, 3, 9, 70, 130, 70), False, True)])
def test_conv3x3_grouped(dev, dtype, shape, relu, use_res):
    """K3-grouped: batch entry b uses weight group b // B0; counted apart from K3."""
    g, b0, h, w, c, o = shape
    gen = _gen(dev, 3 * sum(shape))
    x = torch.randn(g * b0, h, w, c, device=dev, generator=gen).to(dtype)
    k = (torch.randn(g, 3, 3, c, o, device=dev, generator=gen) * (9 * c) ** -0.5).to(dtype)
    bias = torch.randn(g, o, device=dev, generator=gen)
    res = torch.randn(g * b0, h, w, o, device=dev, generator=gen).to(dtype) if use_res else None
    before = _counts()
    got = conv.conv3x3_replicate(x, k, bias, res, relu).float()
    assert _by_kernel(before) == {"conv3x3_grouped": 1}
    want = conv.conv3x3_plain(x.float(), k.float(), bias, None if res is None else res.float(), relu)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=FP32_TOL, atol=FP32_TOL * want.abs().max().item())
    else:
        assert (got - want).abs().max().item() <= K3_BF16_REL * want.abs().max().item()


def _check_conv(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=FP32_TOL, atol=FP32_TOL * want.abs().max().item())
    else:
        assert (got - want).abs().max().item() <= K3_BF16_REL * want.abs().max().item()


def _variant_deltas(before):
    """K3 and K3-grouped launches since ``before``, by variant."""
    deltas = Counter()
    for (kernel, variant), n in _moved(before).items():
        if kernel in ("conv3x3", "conv3x3_grouped"):
            deltas[variant] += n
    return dict(deltas)


# K3 at the main path's shapes (moge-2-vitl-normal, 1369 tokens, batch 1):
# each ConvStack level's res-block convs (ReLU in; ReLU in + residual) and
# its plain convs, and the up2 convs of the neck (4 parities x 32) and the
# heads (the 1x1 folded in: 4 x 3 points/normal, 4 x 1 mask)
MAIN_K3 = [(h, c, o, relu, res, False) for h, c, o in ((74, 256, 256), (148, 128, 128), (296, 64, 64))
           for relu, res in ((True, False), (True, True), (False, False))] + \
          [(296, 64, 32 * 4, False, False, True), (296, 64, 3 * 4, False, False, True),
           (296, 64, 1 * 4, False, False, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c,o,relu,use_res,up2", MAIN_K3)
def test_conv3x3_main_path_shapes(dev, dtype, h, c, o, relu, use_res, up2):
    """Within tolerance of the plain version, one launch counted under one
    variant: a pipelined wgmma variant for bf16. The up2 forms run at their
    input's resolution over parity-expanded weights (4 x the channels)."""
    g = _gen(dev, h * c + o)
    x = torch.randn(1, h, h, c, device=dev, generator=g).to(dtype)
    bias = torch.randn(o // 4 if up2 else o, device=dev, generator=g) * 0.1
    k = torch.randn(3, 3, c, o // 4 if up2 else o, device=dev, generator=g) * (9 * c) ** -0.5
    if up2:  # the operands conv3x3_up2_bilinear hands K3
        k, bias = conv.up2_conv3_expanded(k, bias, dtype)
    k = k.to(dtype).contiguous()
    res = torch.randn(1, h, h, o, device=dev, generator=g).to(dtype) if use_res else None
    before = _counts()
    got = conv.conv3x3_replicate(x, k, bias, res, relu).float()
    want = conv.conv3x3_plain(x.float(), k.float(), bias, None if res is None else res.float(), relu)
    _check_conv(got, want, dtype)
    deltas = _variant_deltas(before)
    assert len(deltas) == 1 and list(deltas.values()) == [1]
    assert next(iter(deltas)) in (("fp32",) if dtype == torch.float32 else conv.PIPELINED)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b0", [1, 2])
@pytest.mark.parametrize("h,c,o,relu,use_res,up2", [(74, 256, 256, True, True, False),
                                                    (296, 64, 3 * 4, False, False, True)])
def test_conv3x3_grouped_main_path_shapes(dev, dtype, b0, h, c, o, relu, use_res, up2):
    """K3-grouped, G = 3 heads: the 74^2 level and the heads' up2 form."""
    gen = _gen(dev, 3 * h + c + o + b0)
    x = torch.randn(3 * b0, h, h, c, device=dev, generator=gen).to(dtype)
    bias = torch.randn(3, o // 4 if up2 else o, device=dev, generator=gen) * 0.1
    k = torch.randn(3, 3, 3, c, o // 4 if up2 else o, device=dev, generator=gen) * (9 * c) ** -0.5
    if up2:
        k, bias = conv.up2_conv3_expanded(k, bias, dtype)
    k = k.to(dtype).contiguous()
    res = torch.randn(3 * b0, h, h, o, device=dev, generator=gen).to(dtype) if use_res else None
    before = _counts()
    got = conv.conv3x3_replicate(x, k, bias, res, relu).float()
    assert _by_kernel(before) == {"conv3x3_grouped": 1}
    want = conv.conv3x3_plain(x.float(), k.float(), bias, None if res is None else res.float(), relu)
    _check_conv(got, want, dtype)
    assert next(iter(_variant_deltas(before))) in (("fp32",) if dtype == torch.float32 else conv.PIPELINED)


@pytest.mark.parametrize("c,o,offset,dtype,variant", [
    (64, 64, 0, torch.bfloat16, "wgmma_tma_cp16"), (24, 20, 0, torch.bfloat16, "wgmma_cp8"),
    (130, 70, 0, torch.bfloat16, "wgmma_cp4"), (7, 9, 0, torch.bfloat16, "wgmma_generic"),
    (64, 64, 1, torch.bfloat16, "wgmma_generic"), (24, 20, 0, torch.float32, "fp32"),
    (66, 20, 0, torch.float32, "fp32"), (7, 20, 0, torch.float32, "fp32_generic"),
    (24, 9, 0, torch.float32, "fp32_generic"), (24, 20, 1, torch.float32, "fp32_generic")])
def test_conv3x3_variants(dev, c, o, offset, dtype, variant):
    """One launch of each copy-width / loader variant, counted under it and
    nowhere else; ``offset`` shifts the input by one element, so its address
    is only 2-byte (bf16) or 4-byte (fp32) aligned and the generic loader
    (bf16) or kernel (fp32) takes it, as an odd C or O does."""
    g = _gen(dev, c * o + offset)
    x = torch.randn(2 * 9 * 13 * c + offset, device=dev, generator=g).to(dtype)[offset:].view(2, 9, 13, c)
    k = (torch.randn(3, 3, c, o, device=dev, generator=g) * (9 * c) ** -0.5).to(dtype)
    bias = torch.randn(o, device=dev, generator=g)
    res = torch.randn(2, 9, 13, o, device=dev, generator=g).to(dtype)
    before = _counts()
    got = conv.conv3x3_replicate(x, k, bias, res, True).float()
    assert _variant_deltas(before) == {variant: 1}
    _check_conv(got, conv.conv3x3_plain(x.float(), k.float(), bias, res.float(), True), dtype)


# K3 at MoGe-1's folder shapes (moge-vitl, fp32, one 480x640 image at 2500
# tokens: the 43 x 57 token grid, the network input 606 x 808): per stage the
# conv after the transposed conv, the res block's conv into the doubled width
# (ReLU in) and back (ReLU in + residual); the two heads' first conv over the
# features and the UV channels (64 + 2 -> 32), with and without a ReLU in
MOGE1_K3 = [(h, w, c, o, relu, res) for h, w, d in ((86, 114, 256), (172, 228, 128), (344, 456, 64))
            for c, o, relu, res in ((d, d, False, False), (d, 2 * d, True, False), (2 * d, d, True, True))] + \
           [(606, 808, 66, 32, False, False), (606, 808, 66, 32, True, False)]


def _f32_case(dev, seed, n, h, w, c, o, groups=0, use_bias=True, use_res=True):
    """An fp32 input (n, h, w, c), (groups,) 3 x 3 x c x o weights, a bias and a residual (or None)."""
    gen = _gen(dev, seed)
    lead = (groups,) if groups else ()
    x = torch.randn(n, h, w, c, device=dev, generator=gen)
    k = torch.randn(*lead, 3, 3, c, o, device=dev, generator=gen) * (9 * c) ** -0.5
    bias = torch.randn(*lead, o, device=dev, generator=gen) * 0.1 if use_bias else None
    res = torch.randn(n, h, w, o, device=dev, generator=gen) if use_res else None
    return x, k, bias, res


def _check_f32_launch(x, k, bias, res, relu, kernel="conv3x3"):
    """One launch of ``kernel`` under ``fp32`` (the tiled kernel), within FP32_TOL of the plain version."""
    before = _counts()
    got = conv.conv3x3_replicate(x, k, bias, res, relu)
    assert _moved(before) == {(kernel, "fp32"): 1}
    _check_conv(got, conv.conv3x3_plain(x, k, bias, res, relu), torch.float32)


@pytest.mark.parametrize("h,w,c,o,relu,use_res", MOGE1_K3)
def test_conv3x3_fp32_moge1_shapes(dev, h, w, c, o, relu, use_res):
    """The tiled fp32 kernel at every conv shape of MoGe-1's folder image."""
    x, k, bias, res = _f32_case(dev, h + c + o + relu, 1, h, w, c, o, use_res=use_res)
    _check_f32_launch(x, k, bias, res, relu)


@pytest.mark.parametrize("n,h,w,c,o,groups,use_bias,use_res,relu", [
    (1, 37, 53, 64, 64, 0, True, True, True),      # H, W not multiples of any patch
    (1, 9, 13, 24, 20, 0, True, False, False),     # one patch, O past the N tile's half
    (2, 23, 41, 48, 100, 0, True, True, True),     # B0 = 2, O = 100 (a partial N tile)
    (2, 86, 114, 256, 256, 0, True, True, True),   # B0 = 2 at folder's smallest level
    (3, 37, 53, 64, 64, 3, True, True, True),      # K3-grouped, G = 3
    (6, 17, 35, 66, 36, 3, True, True, False),     # K3-grouped, G = 3, B0 = 2, C = 66
    (1, 30, 50, 64, 64, 0, False, True, True),     # bias None
    (1, 30, 50, 128, 64, 0, True, False, True),    # residual None
    (1, 30, 50, 16, 12, 0, False, False, False),   # neither
    (1, 1, 1, 8, 12, 0, True, True, True)])        # one pixel: every tap reads it
def test_conv3x3_fp32_edges(dev, n, h, w, c, o, groups, use_bias, use_res, relu):
    x, k, bias, res = _f32_case(dev, n * h * w + c + o, n, h, w, c, o, groups, use_bias, use_res)
    _check_f32_launch(x, k, bias, res, relu, "conv3x3_grouped" if groups else "conv3x3")


@pytest.mark.parametrize("h,c,o,groups", [(148, 64, 32, 0), (296, 64, 3, 0), (296, 64, 1, 0), (37, 64, 3, 3)])
def test_conv3x3_fp32_up2_parity_weights(dev, h, c, o, groups):
    """The up2 form's operands (parity-expanded weights, O' = 4 O): MoGe-2's
    fp32 neck and heads, and the grouped heads."""
    x, k, bias, _ = _f32_case(dev, h + c + o, max(groups, 1), h, h, c, o, groups, use_res=False)
    k, bias = conv.up2_conv3_expanded(k, bias, torch.float32)
    _check_f32_launch(x, k, bias, None, False, "conv3x3_grouped" if groups else "conv3x3")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_up2_bilinear_grouped(dev, dtype):
    gen = _gen(dev, 11)
    x = torch.randn(6, 9, 7, 16, device=dev, generator=gen).to(dtype)
    k = (torch.randn(3, 3, 3, 16, 5, device=dev, generator=gen) * 12 ** -1).to(dtype)
    bias = torch.randn(3, 5, device=dev, generator=gen)
    got = conv.conv3x3_up2_bilinear(x, k, bias).float()
    want = conv.conv3x3_up2_bilinear(x.float().cpu(), k.float().cpu(), bias.cpu())
    tol = (FP32_TOL if dtype == torch.float32 else K3_BF16_REL) * want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= tol


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.randn(4, 6, 5, 8, device=dev)
    with pytest.raises(ValueError):
        conv.conv3x3_replicate(x.permute(0, 2, 1, 3), torch.randn(3, 3, 8, 4, device=dev), None)
    with pytest.raises(ValueError):  # head dim 32: the kernel takes 64
        q = torch.randn(1, 9, 2, 32, device=dev)
        attention.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        norm.layer_norm_fp32(torch.randn(3, 4096, device=dev), torch.ones(4096, device=dev),
                             torch.zeros(4096, device=dev))
    with pytest.raises(ValueError):  # a strided input
        norm.layer_norm_fp32(torch.randn(8, 6, device=dev).t(), torch.ones(8, device=dev), torch.zeros(8, device=dev))
    with pytest.raises(ValueError):  # a bf16 scale
        norm.layer_norm_fp32(torch.randn(3, 8, device=dev), torch.ones(8, device=dev, dtype=torch.bfloat16),
                             torch.zeros(8, device=dev))
    with pytest.raises(TypeError):
        norm.layer_norm_fp32(torch.randn(3, 8, device=dev).half(), torch.ones(8, device=dev),
                             torch.zeros(8, device=dev))
    with pytest.raises(ValueError):  # 4 batch entries, 3 weight groups
        conv.conv3x3_replicate(x, torch.randn(3, 3, 3, 8, 4, device=dev), torch.zeros(3, 4, device=dev))
    with pytest.raises(ValueError):  # a shared bias for grouped weights
        conv.conv3x3_replicate(x, torch.randn(2, 3, 3, 8, 4, device=dev), torch.zeros(4, device=dev))


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_tiny_decode_on_card_matches_cpu(dev, dtype, rtol):
    """Relative L2 per raw map: fp32 on the card within summation order of the
    CPU; bf16 within the bf16 rounding through 4 blocks and the decoder."""
    from moge_tpu_torch.models.v2 import MoGeModel

    gpu = MoGeModel(TINY_CONFIG, dev, torch.float32).init_random(seed=0)
    cpu = MoGeModel(TINY_CONFIG, "cpu", torch.float32)
    cpu.module.load_state_dict({k: v.cpu() for k, v in gpu.module.state_dict().items()}, strict=True)
    image = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 56, 112, 3)).astype(np.float32))
    before = _counts()
    with torch.inference_mode():
        got = gpu.module.decode(image.to(dev), 4, 8, 2.0, dtype)
        want = cpu.module.decode(image, 4, 8, 2.0, torch.float32)
    # per forward: 2 LayerNorms per block + 1 per taken layer; 1 attention per
    # block; per ConvStack 2 convs per res block + 1 per resampler (4 stacks)
    moved = _by_kernel(before)
    counts = (moved["layer_norm"], moved["flash_attention"], moved["conv3x3"])
    assert counts == (2 * 4 + 4, 4, 4 * (2 * 3 + 4))
    for key in want:
        a, b = got[key].float().cpu(), want[key]
        assert ((a - b).norm() / b.norm()).item() <= rtol, key


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_tiny_batched_heads_decode_on_card_matches_cpu(dev, dtype, rtol):
    """Batched heads on the card (K3 for the neck, K3-grouped for the three
    heads) against the sequential heads on the CPU, batch 2."""
    from moge_tpu_torch.models.v2 import MoGeModel

    gpu = MoGeModel(TINY_CONFIG, dev, torch.float32, batched_heads=True).init_random(seed=0)
    cpu = MoGeModel(TINY_CONFIG, "cpu", torch.float32, batched_heads=False)
    cpu.module.load_state_dict({k: v.cpu() for k, v in gpu.module.state_dict().items()}, strict=True)
    image = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 56, 112, 3)).astype(np.float32))
    before = _counts()
    with torch.inference_mode():
        got = gpu.module.decode(image.to(dev), 4, 8, 2.0, dtype)
        want = cpu.module.decode(image, 4, 8, 2.0, torch.float32)
    # neck: 2 convs per res block + 1 per resampler; heads: the same per head, grouped
    moved = _by_kernel(before)
    assert (moved["conv3x3"], moved["conv3x3_grouped"]) == (2 * 3 + 4, 2 * 3 + 4)
    for key in want:
        a, b = got[key].float().cpu(), want[key]
        assert ((a - b).norm() / b.norm()).item() <= rtol, key


def test_tiny_moge1_on_card_matches_cpu(dev):
    from moge_tpu_torch.models.v1 import MoGeModel

    cfg = {"encoder": "dinov2_vitt14", "intermediate_layers": 4, "dim_proj": 32, "dim_upsample": [32, 16, 16],
           "dim_times_res_block_hidden": 2, "num_res_blocks": 1, "remap_output": "exp",
           "res_block_norm": "group_norm", "last_res_blocks": 1, "last_conv_channels": 32, "last_conv_size": 1}
    gpu = MoGeModel(cfg, dev, torch.float32).init_random(seed=0)
    cpu = MoGeModel(cfg, "cpu", torch.float32)
    cpu.module.load_state_dict({k: v.cpu() for k, v in gpu.module.state_dict().items()}, strict=True)
    image = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (1, 112, 140, 3)).astype(np.float32))
    with torch.inference_mode():
        for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            got = gpu.module(image.to(dev), 64, dtype)
            want = cpu.module(image, 64, torch.float32)
            for key in want:
                assert ((got[key].cpu() - want[key]).norm() / want[key].norm()).item() <= rtol, (key, dtype)


def _rel(got, want):
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,kv_valid", [
    (2, 77, 3, None), (1, 130, 2, 100), (1, 64, 1, 1), (2, 200, 2, 130),
    # N on and around the bf16 kernels' 64-row and 128-key tile edges, kv_valid a multiple of 64
    # or 128 and not, and the main path's 1370 tokens
    (1, 64, 2, None), (1, 65, 2, None), (1, 65, 2, 64), (1, 128, 2, None), (1, 128, 2, 64),
    (1, 129, 2, None), (1, 129, 2, 128), (1, 129, 2, 65), (1, 300, 2, 192), (1, 300, 2, 256),
    (2, 1370, 4, None), (1, 1370, 4, 1000), (1, 1370, 2, 1280)])
def test_flash_attention_backward(dev, dtype, b, n, h, kv_valid):
    """K2b-dq and K2b-dkv against autograd through the plain version (fp32,
    same inputs), reached through the qkv Function as the encoder calls it;
    keys at or past kv_valid get zero dk and dv; a second call gives the same
    bits; each launch counted under its variant (bf16: the wgmma kernels)."""
    g = _gen(dev, 7 * n + h)
    qkv = torch.randn(b, n, 3, h, 64, device=dev, generator=g).to(dtype).requires_grad_()
    dout = torch.randn(b, n, h, 64, device=dev, generator=g).to(dtype)
    before = _counts()
    (got,) = torch.autograd.grad(attention.flash_attention_qkv(qkv, kv_valid), qkv, dout)
    moved = _moved(before)
    variant = "wgmma" if dtype == torch.bfloat16 else "fp32"
    assert {key: n for key, n in moved.items() if key[0] != "flash_attention"} == \
        {("flash_attention_dq", variant): 1, ("flash_attention_dkv", variant): 1}
    (again,) = torch.autograd.grad(attention.flash_attention_qkv(qkv, kv_valid), qkv, dout)
    assert torch.equal(got, again)
    ref = qkv.detach().float().requires_grad_()
    (want,) = torch.autograd.grad(
        attention.attention_plain(ref[:, :, 0], ref[:, :, 1], ref[:, :, 2], kv_valid), ref, dout.float())
    # relative to the largest gradient: with one key dq is 0 up to rounding
    tol = (K2B_FP32_REL if dtype == torch.float32 else K2B_BF16_REL) * want.abs().max().item()
    for i, name in enumerate(("dq", "dk", "dv")):
        assert (got[:, :, i].float() - want[:, :, i]).abs().max().item() <= tol, name
    if kv_valid is not None:
        assert not got[:, kv_valid:, 1:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nkv,kv_valid", [(77, 200, 150), (200, 77, 77), (130, 300, 129)])
def test_flash_attention_backward_cross_length(dev, dtype, nq, nkv, kv_valid):
    """``flash_attention_bwd`` with Nq != Nkv, contiguous q and strided k/v,
    against autograd through the plain version."""
    g = _gen(dev, nq * nkv)
    q = torch.randn(2, nq, 3, 64, device=dev, generator=g).to(dtype)
    kv = torch.randn(2, nkv, 2, 3, 64, device=dev, generator=g).to(dtype)
    k, v = kv[:, :, 0], kv[:, :, 1]
    dout = torch.randn(2, nq, 3, 64, device=dev, generator=g).to(dtype)
    out, lse = attention.flash_attention_fwd(q, k, v, kv_valid)
    got = attention.flash_attention_bwd(q, k, v, out, lse, dout, kv_valid)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention.attention_plain(*leaves, kv_valid), leaves, dout.float())
    tol = (K2B_FP32_REL if dtype == torch.float32 else K2B_BF16_REL) * max(w.abs().max().item() for w in want)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert (a.float() - w).abs().max().item() <= tol, name
    assert not got[1][:, kv_valid:].any() and not got[2][:, kv_valid:].any()


@pytest.mark.parametrize("r,length,per_term", [(3, 108, False), (5, 1000, False), (2, 1729, True),
                                               (7, 300, True), (4, 6912, False)])
def test_dense_objective(dev, r, length, per_term):
    """K4 against the chunked broadcast form, at lengths that are not a
    multiple of the candidate tile, with a scalar and a per-term truncation."""
    g = _gen(dev, r * length)
    A, wx, wy = torch.randn(3, r, length, device=dev, generator=g).unbind(0)
    t = torch.rand(r, length, device=dev, generator=g) + 0.5 if per_term else 1.0
    before = _counts()
    got = alignment.dense_objective(A, wx, wy, t)
    assert _moved(before) == {("dense_align", None): 1}
    want = alignment.dense_objective_plain(A, wx, wy, t)
    assert _rel(got, want) <= K4_REL
    # the kernel's argmin attains the plain minimum (near-ties may pick another candidate)
    picked = want.gather(1, got.argmin(-1)[:, None])[:, 0]
    assert ((picked - want.amin(-1)) <= K4_REL * want.abs().max()).all()


@pytest.mark.parametrize("per_term", [False, True])
@pytest.mark.parametrize("impl", ["events", "prefix"])
def test_sorted_align_forms_on_card_match_cpu(dev, monkeypatch, impl, per_term):
    """The sorted truncated-align forms (plain PyTorch, no kernel) on the
    card against the CPU: the same indices, also where zero targets under
    negative x give -0.0 candidates tied with 0.0 ones (which a sort by bit
    pattern would order by sign), a and the loss
    within fp32 summation order (prefix: its cancellation error), no K4."""
    monkeypatch.setenv("MOGE_ALIGN_TRUNC_IMPL", impl)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 300)).astype(np.float32)
    y = (1.7 * x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
    w = (rng.uniform(0, 1, x.shape) * (rng.uniform(size=x.shape) > 0.2)).astype(np.float32)
    y[:, ::4] = 0.0
    x[:, ::8] = -np.abs(x[:, ::8])
    x, y, w = map(torch.from_numpy, (x, y, w))
    t = torch.from_numpy(rng.uniform(0.2, 2.0, x.shape).astype(np.float32)) if per_term else 1.0
    before = _counts()
    got = alignment.align(x.to(dev), y.to(dev), w.to(dev), t.to(dev) if per_term else t)
    assert _by_kernel(before)["dense_align"] == 0
    want = alignment.align(x, y, w, t)
    assert torch.equal(got[2].cpu(), want[2])
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=FP32_TOL, atol=0.0)
    cancel = (y / x.abs().clamp_min(1e-7)).abs().amax(-1) * (w * x.abs()).sum(-1) if impl == "prefix" else 0.0
    assert ((got[1].cpu() - want[1]).abs() <= FP32_TOL * (1 + want[1].abs()) + 4e-7 * cancel).all()


def test_bitonic_network_on_card_matches_stable_sort(dev):
    """The bitonic network (plain PyTorch) on the card: the stable sort's
    permutation, bit for bit, on keys with ties, signed zeros and a
    non-power-of-two length, for fp32 and int32 payloads."""
    rng = np.random.default_rng(6)
    keys = rng.integers(-3, 4, (8, 300)).astype(np.float32)
    keys[:, ::7] = -0.0
    keys[:, ::11] = rng.standard_normal(keys[:, ::11].shape)
    pos = np.broadcast_to(np.arange(300, dtype=np.int32), keys.shape).copy()
    vals = rng.standard_normal(keys.shape).astype(np.float32)
    k, p, v = (torch.from_numpy(a).to(dev) for a in (keys, pos, vals))
    got = bitonic.sort_with_payloads(k, [p, v])
    want = alignment.sort_stable(k, [p, v])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[1].cpu(), bitonic.sort_with_payloads(k.cpu(), [p.cpu(), v.cpu()])[1])


def test_tiny_gradient_on_card_matches_cpu(dev):
    """Gradients of a tiny MoGe-2 forward in fp32: the kernels' autograd
    Functions on the card against the plain versions on the CPU."""
    from moge_tpu_torch.models.v2 import MoGeModel

    gpu = MoGeModel(TINY_CONFIG, dev, torch.float32).init_random(seed=0).module
    cpu = MoGeModel(TINY_CONFIG, "cpu", torch.float32).module
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, strict=True)
    image = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 56, 70, 3)).astype(np.float32))
    grads = []
    for module, img in ((gpu, image.to(dev)), (cpu, image)):
        out = module(img, 20, torch.float32)
        loss = out["points"].square().mean() + out["normal"][..., 0].mean() + out["mask_logit"].mean() \
            + out["metric_scale"].mean()
        loss.backward()
        grads.append({k: p.grad.detach().cpu() for k, p in module.named_parameters() if p.grad is not None})
    assert set(grads[0]) == set(grads[1])
    num = sum((grads[0][k] - grads[1][k]).square().sum() for k in grads[1])
    den = sum(grads[1][k].square().sum() for k in grads[1])
    assert (num / den).sqrt().item() <= 1e-4


def test_dense_objective_rejects_what_the_kernel_does_not_take(dev):
    a = torch.randn(3, 40, device=dev)
    with pytest.raises(ValueError):
        alignment.dense_objective(a.double(), a.double(), a.double(), 1.0)
    with pytest.raises(ValueError):
        alignment.dense_objective(a.t(), a.t(), a.t(), 1.0)


# the ported TPU probes T1-T6 (moge_tpu_torch/tools) against their plain
# versions, each to its tool's REL_TOL relative to max |plain|


# n_pad 192, 64 and 1216 are not multiples of the kernel's 128-key tile
@pytest.mark.parametrize("n,n_pad,bh", [(200, 256, 2), (130, 192, 3), (64, 64, 1), (1201, 1216, 4)])
@pytest.mark.parametrize("variant", ["base", "nobias", "bf16sm", "noexp", "nomax", "mxusum", "mxusum_nomax"])
def test_flash_softmax_variant(dev, variant, n, n_pad, bh):
    from moge_tpu_torch.tools import exp_flash_softmax as fs

    q, k, v, v_ext, bias = fs.make_inputs(n, dev, bh, n_pad, seed=n)
    vin = v_ext if variant.startswith("mxusum") else v
    before = _counts()
    got = fs.flash_softmax_variant(variant, q, k, vin, bias, n).float()
    assert _moved(before) == {("exp_flash_softmax", variant): 1}
    want = fs.flash_softmax_variant_plain(variant, q, k, vin, bias, n).float()
    if variant == "noexp":
        assert not got.any() and not want.any()
    assert (got - want).abs().max().item() <= fs.REL_TOL[variant] * want.abs().max().item()


@pytest.mark.parametrize("kind", ["align", "fma"])
@pytest.mark.parametrize("shape,iters", [((256, 512), 2000), ((3, 37), 7), ((1, 1), 0)])
def test_vpu_ceiling(dev, kind, shape, iters):
    from moge_tpu_torch.tools import exp_vpu_ceiling as vpu

    x, y = vpu.inputs(dev, shape)
    before = _counts()
    got = vpu.vpu_ceiling(x, y, kind, iters, launches=3)
    assert _moved(before) == {("exp_vpu_ceiling", kind): 3}
    want = vpu.vpu_ceiling_plain(x, y, kind, iters)
    assert (got - want).abs().max().item() <= vpu.REL_TOL * want.abs().max().item()


@pytest.mark.parametrize("variant", ["v1", "v1_unroll", "v2", "bf16"])
@pytest.mark.parametrize("r,length", [(5, 40), (3, 2049), (7, 300), (1, 1), (9, 4096), (6, 4097)])
def test_dense_layouts(dev, variant, r, length):
    from moge_tpu_torch.tools import exp_dense_pallas as dense

    _, _, _, A, wx, wy = dense.make_problem(r, length, dev, seed=length)
    want = dense.PLAINS[variant](A, wx, wy, 0.7)
    for tile in dense.VARIANTS[variant][2]:
        before = _counts()
        got = dense.FUNCTIONS[variant](A, wx, wy, 0.7, tile)
        assert _moved(before) == {(f"exp_dense_{variant}", None): 1}
        # relative to max |F|, or to max |wy| where a candidate's own term cancels (L = 1)
        scale = max(want.abs().max().item(), wy.abs().max().item())
        assert (got - want).abs().max().item() <= dense.REL_TOL * scale, tile


def test_probe_wrappers_reject_what_the_kernels_do_not_take(dev):
    from moge_tpu_torch.tools import exp_dense_pallas as dense
    from moge_tpu_torch.tools import exp_flash_softmax as fs
    from moge_tpu_torch.tools import exp_vpu_ceiling as vpu

    q, k, v, v_ext, bias = fs.make_inputs(100, dev, 1, 128)
    with pytest.raises(ValueError):  # a 64-wide V for the validity-column variant
        fs.flash_softmax_variant("mxusum", q, k, v, bias, 100)
    with pytest.raises(ValueError):  # fp32 q
        fs.flash_softmax_variant("base", q.float(), k, v, bias, 100)
    with pytest.raises(ValueError):  # N not a multiple of 64
        fs.flash_softmax_variant("base", q[:, :100].contiguous(), k[:, :100].contiguous(),
                                 v[:, :100].contiguous(), bias[:, :100].contiguous(), 100)
    x, y = vpu.inputs(dev, (4, 8))
    with pytest.raises(ValueError):
        vpu.vpu_ceiling(x.t(), y, "align")
    with pytest.raises(ValueError):
        vpu.vpu_ceiling(x.double(), y.double(), "fma")
    _, _, _, A, wx, wy = dense.make_problem(3, 50, dev)
    with pytest.raises(ValueError):
        dense.dense_objective_v1(A.t(), wx, wy, 1.0)
    with pytest.raises(ValueError):  # a tile the library was not built with
        dense.dense_objective_v2(A, wx, wy, 1.0, tile=16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_launch_the_kernels(dev, dtype):
    """The dispatcher ops' CUDA implementations (the route of a traced
    program) and the wrappers' eager route: each call one launch, counted
    once under its kernel and once under its variant, within the kernel's
    tolerance of its plain version; the two routes give the same bits."""
    g = _gen(dev, 17)
    bf16 = dtype == torch.bfloat16
    x = (torch.randn(1370, 1024, device=dev, generator=g) * 3 + 1).to(dtype)
    s, b = torch.randn(1024, device=dev, generator=g), torch.randn(1024, device=dev, generator=g)
    for call in (lambda: torch.ops.moge.layer_norm(x, s, b, 1e-6), lambda: norm.layer_norm_fp32(x, s, b)):
        before = _counts()
        got = call()
        assert _moved(before) == {("layer_norm", "vec16"): 1}
    assert torch.equal(got, torch.ops.moge.layer_norm(x, s, b, 1e-6))
    want = norm.layer_norm_plain(x.float(), s, b)
    tol = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7) + FP32_TOL if bf16 else FP32_TOL
    assert bool(((got.float() - want).abs() <= tol).all())

    qkv = torch.randn(1, 1370, 3, 16, 64, device=dev, generator=g).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    variant = "wgmma" if bf16 else "fp32"
    for call in (lambda: torch.ops.moge.flash_attention(q, k, v, 1300),
                 lambda: attention.flash_attention_fwd(q, k, v, 1300)):
        before = _counts()
        out, lse = call()
        assert _moved(before) == {("flash_attention", variant): 1}
    want, want_lse = attention.attention_plain(q.float(), k.float(), v.float(), 1300, return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=FP32_TOL, atol=1e-4)
    assert (out.float() - want).abs().max().item() <= (K2_BF16_ABS if bf16 else 10 * FP32_TOL)

    for lead, kernel in (((), "conv3x3"), ((3,), "conv3x3_grouped")):
        xc = torch.randn(3, 74, 74, 64, device=dev, generator=g).to(dtype)
        kc = (torch.randn(*lead, 3, 3, 64, 64, device=dev, generator=g) * 24 ** -1).to(dtype)
        bc = torch.randn(*lead, 64, device=dev, generator=g)
        rc = torch.randn(3, 74, 74, 64, device=dev, generator=g).to(dtype)
        for call in (lambda: torch.ops.moge.conv3x3(xc, kc, bc, rc, True),
                     lambda: conv.conv3x3_replicate(xc, kc, bc, rc, True)):
            before = _counts()
            got = call()
            ((took, variant), n), = _moved(before).items()
            assert (took, n) == (kernel, 1) and variant in (conv.PIPELINED if bf16 else ("fp32",))
        _check_conv(got.float(), conv.conv3x3_plain(xc.float(), kc.float(), bc, rc.float(), True), dtype)


def test_opcheck_on_the_card(dev):
    g = _gen(dev, 19)
    x = torch.randn(37, 192, device=dev, generator=g).to(torch.bfloat16)
    s, b = torch.randn(192, device=dev, generator=g), torch.randn(192, device=dev, generator=g)
    torch.library.opcheck(torch.ops.moge.layer_norm.default, (x, s, b, 1e-6))
    qkv = torch.randn(2, 200, 3, 3, 64, device=dev, generator=g).to(torch.bfloat16)
    torch.library.opcheck(torch.ops.moge.flash_attention.default, (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], 150))
    for lead in ((), (2,)):
        xc = torch.randn(2, 9, 13, 64, device=dev, generator=g).to(torch.bfloat16)
        kc = (torch.randn(*lead, 3, 3, 64, 32, device=dev, generator=g) * 0.05).to(torch.bfloat16)
        for bias, res in ((None, None), (torch.randn(*lead, 32, device=dev, generator=g),
                                         torch.randn(2, 9, 13, 32, device=dev, generator=g).to(torch.bfloat16))):
            torch.library.opcheck(torch.ops.moge.conv3x3.default, (xc, kc, bias, res, True))


def test_raw_forward_export_on_card_matches_cpu_export(dev):
    """moge-2-vits-normal's raw forward exported on the card (fp32, and bf16
    the serving configuration) and on the CPU (fp32): each artifact reloaded
    from its bytes, the card's within summation order (fp32) or within
    ``chip_smoke.MODEL_L2_RTOL`` (bf16) of the CPU's, relative L2 per map;
    the card's artifact launches the kernels through the ops."""
    import sys
    from pathlib import Path

    from moge_tpu_torch.models.export import export_program, load_program
    from moge_tpu_torch.models.presets import get_preset
    from moge_tpu_torch.models.v2 import MoGeModel

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import MODEL_L2_RTOL, expected_launches

    config = get_preset("moge-2-vits-normal")["config"]
    gpu = MoGeModel(config, dev, torch.bfloat16).init_random(seed=0)
    cpu = MoGeModel(config, "cpu", torch.float32)
    cpu.module.load_state_dict({k: v.cpu() for k, v in gpu.module.state_dict().items()}, strict=True)
    image = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 224, 280, 3)).astype(np.float32))
    want = load_program(export_program(cpu, 224, 280, 320))(image)
    expect = expected_launches(config)
    for fp16, rtol in ((False, 1e-4), (True, MODEL_L2_RTOL)):
        program = load_program(export_program(gpu, 224, 280, 320, use_fp16=fp16))
        before = _counts()
        got = program(image.to(dev))
        moved = _by_kernel(before)
        assert (moved["layer_norm"], moved["flash_attention"], moved["conv3x3"]) == \
            (expect["layer_norm"], expect["flash_attention"], expect["conv3x3"])
        assert set(got) == set(want)
        for key in want:
            a, b = got[key].float().cpu(), want[key]
            assert ((a - b).norm() / b.norm()).item() <= rtol, (key, fp16)


def _camera_case(dev, b, h, w, seed, use_mask):
    """``camera_point_maps`` on the card; with a mask and b > 1 one item
    keeps a single pixel (degenerate: (1, 0)) beside sound ones."""
    points, mask, focal = camera_point_maps(b, h, w, seed)
    if use_mask and b > 1:
        mask[b // 2] = False
        mask[b // 2, 0, 0] = True
    return (torch.from_numpy(points).to(dev), torch.from_numpy(mask).to(dev) if use_mask else None,
            torch.from_numpy(focal).to(dev))


@pytest.mark.parametrize("b,h,w", [(1, 90, 120), (8, 90, 120), (1, 480, 640), (8, 518, 518)])
@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("known_focal", [False, True])
def test_camera_solve(dev, b, h, w, use_mask, known_focal):
    """K5 (``recover_focal_shift`` on the card: one launch) against the plain
    version on the card; a known focal is the camera's own."""
    points, mask, focal = _camera_case(dev, b, h, w, b + h + 2 * use_mask, use_mask)
    focal = focal if known_focal else None
    before = _counts()
    got = solvers.recover_focal_shift(points, mask, focal)
    assert _moved(before) == {("camera_solve", None): 1}
    want = solvers._recover_plain(points, mask, focal, (64, 64), 30)
    torch.cuda.synchronize()
    assert [(t.shape, t.dtype) for t in got] == [((b,), torch.float32)] * 2
    z_mean = points[..., 2].abs().mean((1, 2))
    assert (got[0] / want[0] - 1).abs().max().item() <= SOLVE_REL
    assert ((got[1] - want[1]).abs() / z_mean).max().item() <= SOLVE_REL
    if use_mask and b > 1:
        assert (got[0][b // 2].item(), got[1][b // 2].item()) == (1.0, 0.0)
    if known_focal:
        keep = torch.ones(b, dtype=torch.bool, device=dev)
        if use_mask and b > 1:
            keep[b // 2] = False
        assert torch.equal(got[0][keep], focal[keep])


@pytest.mark.parametrize("known_focal", [False, True])
def test_camera_solve_past_the_registers(dev, known_focal):
    """A 96x96 downsample (9216 samples, past the 512 x 8 a block holds in
    registers): the samples gathered again in every pass."""
    points, mask, focal = _camera_case(dev, 8, 480, 640, 9, True)
    focal = focal if known_focal else None
    before = _counts()
    got = solvers.recover_focal_shift(points, mask, focal, downsample_size=(96, 96))
    assert _moved(before) == {("camera_solve", None): 1}
    want = solvers._recover_plain(points, mask, focal, (96, 96), 30)
    z_mean = points[..., 2].abs().mean((1, 2))
    assert (got[0] / want[0] - 1).abs().max().item() <= SOLVE_REL
    assert ((got[1] - want[1]).abs() / z_mean).max().item() <= SOLVE_REL


def test_camera_solve_one_kernel_no_host_sync(dev):
    """A call is one kernel and no copy on the device, and makes no host
    synchronisation, also the first call at a shape (its sample table comes
    from pinned memory without blocking)."""
    points, mask, focal = _camera_case(dev, 8, 518, 518, 4, True)
    solvers.recover_focal_shift(points, mask)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        solvers.recover_focal_shift(points, mask)
        torch.cuda.synchronize()
    device_ops = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device_ops) == 1 and "camera_solve" in device_ops[0], device_ops
    fresh = points[:, :500, :470].contiguous()
    fresh_mask = mask[:, :500, :470].contiguous()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in (None, focal):
            solvers.recover_focal_shift(points, mask, f)
        solvers.recover_focal_shift(fresh, fresh_mask)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_camera_solve_rejects_what_the_kernel_does_not_take(dev):
    points, mask, focal = _camera_case(dev, 2, 90, 120, 5, True)
    for args in ((points.transpose(1, 2).contiguous().transpose(1, 2), mask, None), (points, mask[:, 1:], None),
                 (points, mask.cpu(), None), (points, mask, focal.cpu()), (points.half(), mask, None)):
        with pytest.raises((ValueError, TypeError)):
            torch.ops.moge.camera_solve(*args, 64, 64, 30)
