"""The kernels as dispatcher ops: ``moge::layer_norm`` (K1),
``moge::flash_attention`` (K2), ``moge::conv3x3`` (K3, K3-grouped with a
5-dim kernel) and ``moge::camera_solve`` (K5), registered when
``moge_tpu_torch.ops`` is imported, and the seam they join the program by
(``ops/_build.py``).

On the CPU each op runs its kernel's plain version. ``torch.library.opcheck``
holds each op's schema, its fake implementation (output shapes, dtypes and
strides against the real outputs) and its trace under AOT dispatch with
dynamic shapes, on CPU tensors. Each public wrapper's no-grad path equals the
plain version bit for bit, and its router sends a call to the op while a
program is traced, to the plain version on the CPU, to the launch otherwise,
and to the gradient route when a gradient is needed; K5 takes no gradient
(the routes are checked with spies in their places, on meta tensors off the
CPU, which reach no kernel). On CPU tensors no public entry counts a
launch in the registry, and the registry names every kernel. No module but
``_build`` types a C entry or keeps a launch counter. The CUDA
implementations are held against the plain versions in
tests/test_torch_kernels_cuda.py."""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from moge_tpu_torch.ops import _build, alignment, attention, conv, norm, solvers
from moge_tpu_torch.ops import quant
from moge_tpu_torch.tools import exp_dense_pallas, exp_flash_softmax, exp_vpu_ceiling

PACKAGE = Path(__file__).resolve().parent.parent / "moge_tpu_torch"

torch.set_num_threads(1)


def _t(rng, *shape, dtype=torch.float32, scale=1.0):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) * scale).to(dtype)


SCHEMAS = {
    "layer_norm": "moge::layer_norm(Tensor x, Tensor scale, Tensor bias, float eps) -> Tensor",
    "flash_attention": "moge::flash_attention(Tensor q, Tensor k, Tensor v, int kv_valid) -> (Tensor, Tensor)",
    "conv3x3": "moge::conv3x3(Tensor x, Tensor kernel, Tensor? bias, Tensor? residual, bool input_relu) -> Tensor",
    "camera_solve": "moge::camera_solve(Tensor points, Tensor? mask, Tensor? focal, int out_h, int out_w, "
                    "int iters) -> (Tensor, Tensor)"}


@pytest.mark.parametrize("name", SCHEMAS)
def test_ops_are_registered_with_their_schemas(name):
    assert str(getattr(torch.ops.moge, name).default._schema) == SCHEMAS[name]


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


def _tensor(device, *shape, grad=False):
    return torch.empty(*shape, device=device, requires_grad=grad)


# each public entry: its router and a call of it on tensors of a device,
# gradient taken through its first argument or not
ENTRIES = {
    "layer_norm": (lambda: norm.ROUTER, lambda d, g: norm.layer_norm_fp32(
        _tensor(d, 4, 8, 64, grad=g), _tensor(d, 64), _tensor(d, 64))),
    "flash_attention_qkv": (lambda: attention.QKV_ROUTER, lambda d, g: attention.flash_attention_qkv(
        _tensor(d, 1, 8, 3, 2, 64, grad=g))),
    "flash_attention_fwd": (lambda: attention.ROUTER, lambda d, g: attention.flash_attention_fwd(
        *(_tensor(d, 1, 8, 2, 64, grad=g) for _ in range(3)))),
    "conv3x3": (lambda: conv.ROUTER, lambda d, g: conv.conv3x3_replicate(
        _tensor(d, 1, 4, 8, 64, grad=g), _tensor(d, 3, 3, 64, 8), None)),
    "camera_solve": (lambda: solvers.ROUTER, lambda d, g: solvers.recover_focal_shift(
        _tensor(d, 1, 6, 5, 3, grad=g))),
}


def _route(entry, device, grad, tracing):
    """The route a call takes: K5 takes no gradient; the rest go to the op
    while traced without one, the plain version on the CPU, then the
    launch without a gradient, else the gradient route."""
    grad = grad and entry != "camera_solve"
    if tracing and not grad:
        return "op"
    if device == "cpu":
        return "plain"
    return "autograd" if grad else "launch"


def _spy_on(router, monkeypatch):
    out = torch.empty(1, device="meta")
    spies = {route: _Spy((out, out) if router in (attention.ROUTER, solvers.ROUTER) else out)
             for route in ("op", "plain", "launch", "autograd")}
    for route, spy in spies.items():
        monkeypatch.setattr(router, route, spy)
    return spies


@pytest.mark.parametrize("grad,tracing", [(False, False), (False, True), (True, False), (True, True)])
@pytest.mark.parametrize("entry", ENTRIES)
def test_wrappers_route_off_the_cpu(entry, monkeypatch, grad, tracing):
    """Meta tensors (past the device check): no gradient to take, the launch
    eagerly, the op while a program is traced; a gradient to take, the
    gradient route (K1 and K3: the plain VJP; K2 over a qkv: forward K2 and
    backward K2b; K2's forward entry: the launch), traced or not; K5 the op
    when traced, else the launch."""
    monkeypatch.setattr(_build, "require_cuda_tensor", lambda t, what: None)
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: tracing)
    router, call = ENTRIES[entry]
    spies = _spy_on(router(), monkeypatch)
    call("meta", grad)
    want = _route(entry, "meta", grad, tracing)
    assert {k: s.calls for k, s in spies.items()} == {k: int(k == want) for k in spies}


@pytest.mark.parametrize("grad,tracing", [(False, False), (False, True), (True, False), (True, True)])
@pytest.mark.parametrize("entry", ENTRIES)
def test_wrappers_route_on_the_cpu(entry, monkeypatch, grad, tracing):
    """CPU tensors: the plain version, unless traced without a gradient to
    take (the op); K5 the op when traced, else the plain version."""
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: tracing)
    router, call = ENTRIES[entry]
    spies = _spy_on(router(), monkeypatch)
    call("cpu", grad)
    want = _route(entry, "cpu", grad, tracing)
    assert {k: s.calls for k, s in spies.items()} == {k: int(k == want) for k in spies}


def test_gradient_routes():
    """K1 and K3 share the plain-VJP Function over their launches; K2's
    forward entry launches with a gradient to take; over a qkv, _FlashQKV."""
    for module, plain in ((norm, norm.layer_norm_plain), (conv, conv.conv3x3_plain)):
        route = module.ROUTER.autograd
        assert (route.func, route.args) == (_build.PlainVJP.apply, (module._launch, plain))
    assert attention.ROUTER.autograd is attention._launch
    assert attention.QKV_ROUTER.autograd == attention._FlashQKV.apply


@pytest.mark.parametrize("op", ["layer_norm", "conv3x3", "conv3x3_no_bias"])
def test_plain_vjp_is_the_plain_versions_gradient(op):
    """The gradient route of K1 and K3, with the plain version standing in
    for the launch: forward and gradients (None for a None input, none for
    the trailing flag) equal autograd through the plain version."""
    rng = np.random.default_rng(4)
    if op == "layer_norm":
        plain, args = norm.layer_norm_plain, [_t(rng, 3, 5, 64), _t(rng, 64), _t(rng, 64), 1e-6]
    else:
        plain = conv.conv3x3_plain
        args = [_t(rng, 2, 5, 6, 8), _t(rng, 3, 3, 8, 4, scale=0.2), None if op == "conv3x3_no_bias" else _t(rng, 4),
                _t(rng, 2, 5, 6, 4), True]
    leaves = [a.requires_grad_() if isinstance(a, torch.Tensor) else a for a in args]
    tensors = [a for a in leaves if isinstance(a, torch.Tensor)]
    got = _build.PlainVJP.apply(plain, plain, *leaves)
    g = torch.randn_like(got)
    want = plain(*leaves)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(got, tensors, g),
                                                 torch.autograd.grad(want, tensors, g)))


class _Block(torch.nn.Module):
    def __init__(self, op):
        super().__init__()
        self.op = op

    def forward(self, x, qkv, kernel, points):
        if self.op == "layer_norm":
            return norm.layer_norm_fp32(x, torch.ones(64), torch.zeros(64))
        if self.op == "flash_attention":
            return attention.flash_attention_qkv(qkv)
        if self.op == "conv3x3":
            return conv.conv3x3_replicate(x, kernel, None, input_relu=True)
        return solvers.recover_focal_shift(points, points[..., 2] > 0)


@pytest.mark.parametrize("op", SCHEMAS)
def test_export_records_the_ops(op):
    """A traced program holds one op node per wrapper call, on the CPU, and
    gives the eager call's bits."""
    rng = np.random.default_rng(2)
    points = _t(rng, 1, 12, 10, 3)
    points[..., 2] = points[..., 2].abs() + 1
    args = (_t(rng, 1, 4, 5, 64), _t(rng, 1, 9, 3, 2, 64), _t(rng, 3, 3, 64, 8, scale=0.1), points)
    with torch.no_grad():
        program = torch.export.export(_Block(op), args, strict=False)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function" and "moge" in str(n.target)]
    assert targets == [f"moge.{op}.default"]
    got = program.module()(*args)
    with torch.no_grad():
        want = _Block(op)(*args)
    got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


KERNELS = {"layer_norm", "flash_attention", "flash_attention_dq", "flash_attention_dkv", "conv3x3", "conv3x3_grouped",
           "dense_align", "camera_solve", "int8_product", "exp_flash_softmax", "exp_vpu_ceiling",
           *(f"exp_dense_{v}" for v in exp_dense_pallas.VARIANTS)}


def test_read_names_every_kernel_and_its_variants():
    read = _build.read_launches()
    assert set(read) == KERNELS
    assert {k: set(read[k]) for k in ("layer_norm", "flash_attention", "flash_attention_dq", "conv3x3",
                                      "conv3x3_grouped", "exp_vpu_ceiling")} == {
        "layer_norm": {"vec16", "scalar"}, "flash_attention": {"wgmma", "fp32"},
        "flash_attention_dq": {"wgmma", "fp32"}, "conv3x3": set(conv.VARIANTS), "conv3x3_grouped": set(conv.VARIANTS),
        "exp_vpu_ceiling": {"align", "fma"}}
    assert set(read["exp_flash_softmax"]) == set(exp_flash_softmax.VARIANTS)


def test_reset_clears_the_registry():
    _build.count("layer_norm", "vec16")
    _build.count("int8_product", n=3)
    read = _build.read_launches()
    assert (read["layer_norm"], read["int8_product"]) == ({"vec16": 1, "scalar": 0}, {None: 3})
    _build.reset_launches()
    assert all(n == 0 for variants in _build.read_launches().values() for n in variants.values())


def _cpu_calls():
    """Every public entry of a kernel on CPU tensors."""
    rng = np.random.default_rng(3)
    x, qkv = _t(rng, 5, 64), _t(rng, 1, 9, 3, 2, 64)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    xc, kc = _t(rng, 2, 4, 5, 8), _t(rng, 3, 3, 8, 4)
    A = _t(rng, 3, 16)
    points = _t(rng, 2, 12, 10, 3)
    points[..., 2] = points[..., 2].abs() + 1
    x_q, w_q = quant.quantize(_t(rng, 20, 16))[0], quant.quantize(_t(rng, 8, 16))[0]
    fs_in = exp_flash_softmax.make_inputs(50, "cpu", bh=1)
    return {
        "layer_norm_fp32": lambda: norm.layer_norm_fp32(x, torch.ones(64), torch.zeros(64)),
        "flash_attention": lambda: attention.flash_attention(q, k, v, 7),
        "flash_attention_qkv": lambda: attention.flash_attention_qkv(qkv.clone().requires_grad_()).sum().backward(),
        "flash_attention_bwd": lambda: attention.flash_attention_bwd(q, k, v, *attention.flash_attention_fwd(q, k, v),
                                                                     torch.ones_like(q)),
        "conv3x3_replicate": lambda: conv.conv3x3_replicate(xc, kc, None, input_relu=True),
        "conv3x3_grouped": lambda: conv.conv3x3_replicate(xc, torch.stack([kc, kc]), None),
        "conv3x3_up2_bilinear": lambda: conv.conv3x3_up2_bilinear(xc, kc, torch.zeros(4)),
        "recover_focal_shift": lambda: solvers.recover_focal_shift(points),
        "dense_objective": lambda: alignment.dense_objective(A, A.abs(), A, 0.5),
        "int8_product": lambda: quant.int8_product(x_q, w_q),
        "flash_softmax_variant": lambda: exp_flash_softmax.flash_softmax_variant("base", *fs_in[:3], fs_in[4], 50),
        "vpu_ceiling": lambda: exp_vpu_ceiling.vpu_ceiling(A, A, "align", iters=3),
        "dense_objective_v1": lambda: exp_dense_pallas.dense_objective_v1(A, A.abs(), A, 0.5),
    }


@pytest.mark.parametrize("entry", sorted(_cpu_calls()))
def test_cpu_entries_count_no_launch(entry):
    _build.reset_launches()
    _cpu_calls()[entry]()
    assert not any(_build.LAUNCHES.values())


_TYPED = re.compile(r"\.(argtypes|restype)\s*=")


def test_only_the_seam_types_entries_and_counts_launches():
    """No module but ops/_build.py sets a C entry's argtypes or restype, or
    keeps a module-level launch counter."""
    typed, counters = [], []
    for path in sorted(PACKAGE.rglob("*.py")):
        if path == PACKAGE / "ops" / "_build.py":
            continue
        source = path.read_text()
        typed += [path.name] if _TYPED.search(source) else []
        for node in ast.parse(source).body:
            targets = node.targets if isinstance(node, ast.Assign) else [node.target] \
                if isinstance(node, ast.AnnAssign) else []
            counters += [f"{path.name}:{t.id}" for t in targets
                         if isinstance(t, ast.Name) and t.id.endswith("LAUNCHES")]
    assert (typed, counters) == ([], [])
