"""The kernels as dispatcher ops: ``moge::layer_norm`` (K1),
``moge::flash_attention`` (K2) and ``moge::conv3x3`` (K3, K3-grouped with a
5-dim kernel), registered when ``moge_tpu_torch.ops`` is imported.

On the CPU each op runs its kernel's plain version. ``torch.library.opcheck``
holds each op's schema, its fake implementation (output shapes, dtypes and
strides against the real outputs) and its trace under AOT dispatch with
dynamic shapes, on CPU tensors. Each public wrapper's no-grad path equals the
plain version bit for bit, and it routes a call to the op while a program is
traced, to the launch otherwise, and to the autograd Function when a gradient
is needed (the routes on the card are checked with spies on meta tensors,
which reach no kernel). The CUDA implementations are held against the plain
versions in tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from moge_tpu_torch.ops import _build, attention, conv, norm

torch.set_num_threads(1)


def _t(rng, *shape, dtype=torch.float32, scale=1.0):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) * scale).to(dtype)


def test_ops_are_registered_with_their_schemas():
    schemas = {name: str(getattr(torch.ops.moge, name).default._schema)
               for name in ("layer_norm", "flash_attention", "conv3x3")}
    assert schemas == {
        "layer_norm": "moge::layer_norm(Tensor x, Tensor scale, Tensor bias, float eps) -> Tensor",
        "flash_attention": "moge::flash_attention(Tensor q, Tensor k, Tensor v, int kv_valid) -> (Tensor, Tensor)",
        "conv3x3": "moge::conv3x3(Tensor x, Tensor kernel, Tensor? bias, Tensor? residual, bool input_relu) "
                   "-> Tensor"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 1024])
def test_opcheck_layer_norm(d, dtype):
    rng = np.random.default_rng(d)
    x = _t(rng, 2, 37, d, dtype=dtype, scale=3.0)
    torch.library.opcheck(torch.ops.moge.layer_norm.default, (x, _t(rng, d), _t(rng, d), 1e-6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nkv,h,kv_valid", [(2, 37, 37, 3, 37), (1, 37, 37, 2, 20), (2, 21, 50, 3, 45)],
                         ids=["self", "kv_valid", "cross"])
def test_opcheck_flash_attention(b, nq, nkv, h, kv_valid, dtype):
    """q, k and v the strided per-head views of (B, N, 3, H, 64) projections,
    as the encoder passes them; keys at or past ``kv_valid`` masked; Nq != Nkv."""
    rng = np.random.default_rng(nq * nkv + kv_valid)
    qkv = _t(rng, b, nkv, 3, h, 64, dtype=dtype)
    q = qkv[:, :, 0] if nq == nkv else _t(rng, b, nq, 3, h, 64, dtype=dtype)[:, :, 0]
    args = (q, qkv[:, :, 1], qkv[:, :, 2], kv_valid)
    assert not args[1].is_contiguous()
    torch.library.opcheck(torch.ops.moge.flash_attention.default, args)


@pytest.mark.parametrize("groups", [0, 3], ids=["K3", "K3-grouped"])
@pytest.mark.parametrize("use_bias,use_res,relu", [(False, False, False), (True, False, True), (True, True, False),
                                                   (False, True, True)])
def test_opcheck_conv3x3(groups, use_bias, use_res, relu):
    rng = np.random.default_rng(groups + 2 * use_bias + 4 * use_res + 8 * relu)
    lead = (groups,) if groups else ()
    x = _t(rng, 3, 7, 9, 8)
    kernel = _t(rng, *lead, 3, 3, 8, 12, scale=0.2)
    bias = _t(rng, *lead, 12) if use_bias else None
    residual = _t(rng, 3, 7, 9, 12) if use_res else None
    torch.library.opcheck(torch.ops.moge.conv3x3.default, (x, kernel, bias, residual, relu))


def test_no_grad_wrappers_equal_the_plain_versions_bit_for_bit():
    """On the CPU the wrappers and the ops (the route a traced program takes)
    both give the plain versions' bits."""
    rng = np.random.default_rng(0)
    x, s, b = _t(rng, 37, 192, scale=3.0), _t(rng, 192), _t(rng, 192)
    want = norm.layer_norm_plain(x, s, b, 1e-6)
    assert torch.equal(norm.layer_norm_fp32(x, s, b), want)
    assert torch.equal(torch.ops.moge.layer_norm(x, s, b, 1e-6), want)

    qkv = _t(rng, 2, 37, 3, 3, 64)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out, lse = attention.attention_plain(q, k, v, 30, return_lse=True)
    for got in (attention.flash_attention_fwd(q, k, v, 30), torch.ops.moge.flash_attention(q, k, v, 30)):
        assert torch.equal(got[0], out) and torch.equal(got[1], lse)
    assert torch.equal(attention.flash_attention(q, k, v, 30), out)
    assert torch.equal(attention.flash_attention_qkv(qkv, 30), out)

    for lead in ((), (3,)):
        x = _t(rng, 3, 6, 5, 8)
        kernel, bias, res = _t(rng, *lead, 3, 3, 8, 4, scale=0.2), _t(rng, *lead, 4), _t(rng, 3, 6, 5, 4)
        want = conv.conv3x3_plain(x, kernel, bias, res, True)
        assert torch.equal(conv.conv3x3_replicate(x, kernel, bias, res, True), want)
        assert torch.equal(torch.ops.moge.conv3x3(x, kernel, bias, res, True), want)


def test_grad_path_on_the_cpu_is_the_plain_version_under_autograd():
    rng = np.random.default_rng(1)
    x = _t(rng, 5, 64).requires_grad_()
    s, b = _t(rng, 64), _t(rng, 64)
    (g,) = torch.autograd.grad(norm.layer_norm_fp32(x, s, b).square().sum(), x)
    (want,) = torch.autograd.grad(norm.layer_norm_plain(x, s, b).square().sum(), x)
    assert torch.equal(g, want)
    qkv = _t(rng, 1, 9, 3, 2, 64).requires_grad_()
    (g,) = torch.autograd.grad(attention.flash_attention_qkv(qkv).square().sum(), qkv)
    (want,) = torch.autograd.grad(attention.attention_plain(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).square().sum(),
                                  qkv)
    assert torch.equal(g, want)


class _Spy:
    def __init__(self, result):
        self.calls, self.result = 0, result

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.result


@pytest.fixture
def routes(monkeypatch):
    """Each wrapper's three routes off the CPU as spies: the launch, the
    autograd Function and the op; meta tensors pass the device check."""
    monkeypatch.setattr(_build, "require_cuda_tensor", lambda t, what: None)
    out = torch.empty(0, device="meta")
    spies = {}
    for name, module, function, op in (("layer_norm", norm, norm._LayerNorm, "layer_norm"),
                                       ("flash_attention", attention, attention._FlashQKV, "flash_attention"),
                                       ("conv3x3", conv, conv._Conv3x3, "conv3x3")):
        result = (out, out) if name == "flash_attention" else out
        spies[name] = {"launch": _Spy(result), "function": _Spy(out), "op": _Spy(result)}
        monkeypatch.setattr(module, "_launch", spies[name]["launch"])
        monkeypatch.setattr(function, "apply", spies[name]["function"])
        monkeypatch.setattr(torch.ops.moge, op, spies[name]["op"])
    return spies


def _call_each(grad):
    x = torch.empty(4, 8, 64, device="meta", requires_grad=grad)
    norm.layer_norm_fp32(x, torch.empty(64, device="meta"), torch.empty(64, device="meta"))
    attention.flash_attention_qkv(torch.empty(1, 8, 3, 2, 64, device="meta", requires_grad=grad))
    conv.conv3x3_replicate(torch.empty(1, 4, 8, 64, device="meta", requires_grad=grad),
                           torch.empty(3, 3, 64, 8, device="meta"), None)


@pytest.mark.parametrize("grad,tracing,route", [(False, False, "launch"), (False, True, "op"),
                                                (True, False, "function"), (True, True, "function")])
def test_wrappers_route_off_the_cpu(routes, monkeypatch, grad, tracing, route):
    """No gradient to take: the launch eagerly, the op while a program is
    traced; a gradient to take: the autograd Function (K1, K2 forward and
    K2b backward, K3), traced or not."""
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: tracing)
    _call_each(grad)
    for name, spies in routes.items():
        assert {k: s.calls for k, s in spies.items()} == {k: int(k == route) for k in spies}, name


def test_export_records_the_ops():
    """A traced program holds one op node per wrapper call, on the CPU."""

    class Block(torch.nn.Module):
        def forward(self, x, qkv, kernel):
            y = norm.layer_norm_fp32(x, torch.ones(64), torch.zeros(64))
            return y, attention.flash_attention_qkv(qkv), conv.conv3x3_replicate(x, kernel, None, input_relu=True)

    rng = np.random.default_rng(2)
    args = (_t(rng, 1, 4, 5, 64), _t(rng, 1, 9, 3, 2, 64), _t(rng, 3, 3, 64, 8, scale=0.1))
    with torch.no_grad():
        program = torch.export.export(Block(), args, strict=False)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function" and "moge" in str(n.target)]
    assert sorted(targets) == ["moge.conv3x3.default", "moge.flash_attention.default", "moge.layer_norm.default"]
    got = program.module()(*args)
    with torch.no_grad():
        want = Block()(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
