"""The port's W8A8 int8 serving mode (moge_tpu_torch.ops.quant) against the
JAX package's (moge_tpu/ops/quant.py, tests/test_quant.py) on the CPU:
exactness on representable inputs; ties rounded half to even;
``quant_matmul`` step for step against
JAX's (the int8 operands and int32 accumulators equal, caught at JAX's
``dot_general``; the fp32 output within rtol 1e-6); ``QuantLinear``'s
parameters equal ``Linear``'s; the tiny ViT's int8 drift against fp32;
int8 ``infer`` against JAX's ``use_int8=True`` infer (and the port's fp32
``infer`` as a control that must miss); int8 drift against
the port's own fp32 ``infer``; ``serve --int8`` through the CLI."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moge_tpu.models.convert import convert_moge2
from moge_tpu.models.v2 import MoGeModel as JaxMoGeModel
from moge_tpu.ops.quant import quant_matmul as jax_quant_matmul
from moge_tpu_torch.models.dinov2 import VIT_ARCHS, DinoVisionTransformer, Linear
from moge_tpu_torch.models.modules import init_params
from moge_tpu_torch.models.v2 import MoGeModel
from moge_tpu_torch.ops import _build
from moge_tpu_torch.ops.quant import QuantLinear, int8_product, quant_matmul, quantize
from torch_tiny_config import TINY_CONFIG, make_points_perspective, state_dict_from_jax_params

torch.set_num_threads(1)

OUT_RTOL = 1e-6  # fp32 scaling of equal int32 accumulators: the same operations in the same order
DRIFT = 0.05  # tests/test_quant.py's serving-mode drift bound
INFER_ATOL, INFER_RTOL = 1e-3, 1e-2  # tests/test_sp.py::test_sp_model_infer_matches's class
NUM_TOKENS = 120
# int8 turns 1e-7 input differences (the two packages' fp32 reduction orders)
# into map changes of up to a few 1e-3: a rounding step of a quantized
# activation moves its whole product term. Measured on the tiny model, the
# port's int8 points and depth stay elementwise within INFER_ATOL / INFER_RTOL
# of JAX's (at most 0.56 of the allowance, nearly a uniform scale of the
# solved map), while its fp32 maps do not (1.14 of it: 77% of the points and
# every depth outside). Normals are unit vectors whose near-zero components
# take no rtol, and single rounding flips move them by up to 35 x the
# allowance, so they are held to INFER_RTOL as a relative L2 (int8 7.8e-3,
# fp32 1.28e-2), and the masks to MASK_AGREE (int8 0.998, fp32 0.997).
MASK_AGREE = 0.99

def test_quant_matmul_exact_on_representable_inputs():
    """Inputs on the int8 grid with max-abs 127 (tests/test_quant.py's case): exact."""
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, (4, 16)).astype(np.float32)
    w = rng.integers(-127, 128, (16, 8)).astype(np.float32)
    x[:, 0] = 127.0
    w[0, :] = 127.0
    x, w = torch.from_numpy(x * 0.5), torch.from_numpy(w * 0.25)
    np.testing.assert_allclose(quant_matmul(x, w.T).numpy(), (x @ w).numpy(), rtol=1e-6)


def test_quantize_rounds_half_to_even():
    """Ties on the int8 grid (a row with max-abs 127 has scale 1) round to
    even, as JAX's ``jnp.round``: seen through an identity weight, whose
    int8 product returns the quantized row."""
    x = np.array([[127.0, 2.5, -2.5, 3.5, 0.5, -0.5, 126.5, -1.5]], np.float32)
    want = np.array([[127, 2, -2, 4, 0, 0, 126, -2]], np.float32)
    x_q, scale = quantize(torch.from_numpy(x))
    assert scale.item() == 1.0
    np.testing.assert_array_equal(x_q.numpy(), want)
    eye = np.eye(8, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(jax_quant_matmul(jnp.asarray(x), jnp.asarray(eye), None)), want, rtol=1e-6)
    np.testing.assert_allclose(quant_matmul(torch.from_numpy(x), torch.from_numpy(eye)).numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
def test_quant_matmul_matches_jax(monkeypatch, with_bias):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 64, 256)).astype(np.float32)
    x[0, 5] = 0.0  # a zero row takes scale 1
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    w[:, 7] = 0.0  # a zero output channel too
    bias = rng.standard_normal(128).astype(np.float32) if with_bias else None

    seen = {}
    dot_general = jax.lax.dot_general

    def spy(a, b, *args, **kwargs):
        out = dot_general(a, b, *args, **kwargs)
        seen.update(x_q=np.asarray(a), w_q=np.asarray(b), acc=np.asarray(out))
        return out

    monkeypatch.setattr(jax.lax, "dot_general", spy)
    want = np.asarray(jax_quant_matmul(jnp.asarray(x), jnp.asarray(w), None if bias is None else jnp.asarray(bias)))

    xt, wt = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T))
    x_q, _ = quantize(xt.reshape(-1, 256))
    w_q, _ = quantize(wt)
    assert x_q.dtype == w_q.dtype == torch.int8
    np.testing.assert_array_equal(x_q.numpy(), seen["x_q"].reshape(-1, 256))
    np.testing.assert_array_equal(w_q.numpy(), seen["w_q"].T)
    acc = int8_product(x_q, w_q)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), seen["acc"].reshape(-1, 128))
    got = quant_matmul(xt, wt, None if bias is None else torch.from_numpy(bias))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=OUT_RTOL, atol=0)
    assert _build.read_launches()["int8_product"] == {None: 0}  # the plain product on CPU tensors


def test_quant_linear_has_linears_parameters():
    """QuantLinear's state dict (and an int8 ViT's) has Linear's keys, shapes
    and dtypes, so checkpoints load unchanged; its output has the input's dtype."""
    lin, qlin = Linear(16, 8), QuantLinear(16, 8)
    assert [(k, v.shape, v.dtype) for k, v in lin.state_dict().items()] == \
        [(k, v.shape, v.dtype) for k, v in qlin.state_dict().items()]
    cfg = VIT_ARCHS["dinov2_vitt14"]
    sd, sd8 = DinoVisionTransformer(cfg).state_dict(), DinoVisionTransformer(cfg, use_int8=True).state_dict()
    assert [(k, v.shape, v.dtype) for k, v in sd.items()] == [(k, v.shape, v.dtype) for k, v in sd8.items()]
    assert qlin(torch.zeros(3, 16, dtype=torch.bfloat16)).dtype == torch.bfloat16


def test_int8_vit_drift():
    """The tiny ViT's last patch tokens, int8 against fp32 (tests/test_quant.py's bound)."""
    cfg = VIT_ARCHS["dinov2_vitt14"]
    vit = DinoVisionTransformer(cfg)
    init_params(vit, seed=0)
    vit8 = DinoVisionTransformer(cfg, use_int8=True)
    vit8.load_state_dict(vit.state_dict(), strict=True)
    image = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (1, 4 * 14, 5 * 14, 3)).astype(np.float32))
    with torch.inference_mode():
        (p_ref, _), = vit(image, (3,), torch.float32)
        (p_q, _), = vit8(image, (3,), torch.float32)
    drift = ((p_q - p_ref).norm() / p_ref.norm()).item()
    assert 0 < drift < DRIFT, drift


@pytest.fixture(scope="module")
def perspective_weights():
    """The tiny MoGe-2 with a well-conditioned point map, as the port's
    state dict and as JAX params."""
    model = MoGeModel(TINY_CONFIG, "cpu", torch.float32).init_random(seed=0)
    make_points_perspective(model.module)
    sd = {k: v.clone() for k, v in model.module.state_dict().items()}
    _, params = convert_moge2({"model_config": TINY_CONFIG, "model": {k: np.array(v) for k, v in sd.items()}})
    return sd, params


def _int8_misses(got, want) -> list:
    """The criteria of ``test_int8_infer_matches_jax`` that ``got`` misses
    against JAX's answer ``want``: the masks agree on MASK_AGREE of the
    pixels; where both hold, points and depth within INFER_ATOL / INFER_RTOL
    elementwise and the normals within INFER_RTOL as a relative L2; the
    intrinsics within INFER_ATOL / INFER_RTOL."""
    assert set(got) == set(want) == {"points", "depth", "intrinsics", "mask", "normal"}
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    both = got["mask"] & want["mask"]
    misses = [] if (got["mask"] == want["mask"]).mean() >= MASK_AGREE else ["mask"]
    for key in ("points", "depth"):
        if not np.allclose(got[key][both], want[key][both], atol=INFER_ATOL, rtol=INFER_RTOL):
            misses.append(key)
    a, b = got["normal"][both], want["normal"][both]
    if not np.linalg.norm(a - b) <= INFER_RTOL * np.linalg.norm(b):
        misses.append("normal")
    if not np.allclose(got["intrinsics"], want["intrinsics"], atol=INFER_ATOL, rtol=INFER_RTOL):
        misses.append("intrinsics")
    return misses


def test_int8_infer_matches_jax(perspective_weights):
    """The port's int8 infer against JAX's meets every criterion; as a
    control, the port's fp32 infer against JAX's int8 misses points and
    depth, so the criteria tell the int8 arithmetic from its absence."""
    sd, params = perspective_weights
    jax_model = JaxMoGeModel(TINY_CONFIG, params, dtype=jnp.float32, use_int8=True)
    image = np.random.default_rng(3).uniform(0, 1, (2, 56, 70, 3)).astype(np.float32)
    want = jax_model.infer(jnp.asarray(image), num_tokens=NUM_TOKENS, use_fp16=False)
    misses = {}
    for use_int8 in (True, False):
        model = MoGeModel(TINY_CONFIG, "cpu", torch.float32, use_int8=use_int8)
        model.module.load_state_dict(sd, strict=True)
        misses[use_int8] = _int8_misses(model.infer(torch.from_numpy(image), num_tokens=NUM_TOKENS,
                                                    use_fp16=False), want)
    assert misses[True] == []
    assert {"points", "depth"} <= set(misses[False]), misses[False]

def test_int8_infer_drift_against_fp32():
    """tests/test_quant.py::test_int8_model_infer_runs at the port: JAX's
    random weights (seed 0), depth without the mask, int8 against fp32."""
    jax_model = JaxMoGeModel(TINY_CONFIG, None, dtype=jnp.float32).init_random(seed=0, image_hw=(56, 56))
    sd = state_dict_from_jax_params(TINY_CONFIG, jax.tree.map(np.asarray, jax_model.params))
    models = {}
    for use_int8 in (False, True):
        models[use_int8] = MoGeModel(TINY_CONFIG, "cpu", torch.float32, use_int8=use_int8)
        models[use_int8].module.load_state_dict(sd, strict=True)
    image = np.random.default_rng(3).uniform(0, 1, (56, 56, 3)).astype(np.float32)
    ref, out = (models[q].infer(image, num_tokens=NUM_TOKENS, use_fp16=False, apply_mask=False) for q in (False, True))
    assert set(out) == set(ref)
    d_ref, d_q = ref["depth"].numpy(), out["depth"].numpy()
    fin = np.isfinite(d_ref) & np.isfinite(d_q)
    assert fin.mean() > 0.9
    rel = np.abs(d_q[fin] - d_ref[fin]) / np.maximum(d_ref[fin], 1e-3)
    assert 0 < np.median(rel) < DRIFT, np.median(rel)


@pytest.fixture
def checkpoint(tmp_path, perspective_weights):
    path = tmp_path / "model.pt"
    torch.save({"model_config": TINY_CONFIG, "model": perspective_weights[0]}, path)
    return path


def test_serve_int8_cli(checkpoint, monkeypatch):
    """``serve --int8`` builds the int8 v2 model and answers a request
    (the server's loop replaced by one request through its batcher); for
    v1 it is refused with the JAX command's message."""
    from click.testing import CliRunner

    from moge_tpu_torch.scripts import serve

    seen = {}
    create_server = serve.create_server

    def one_request(model, *args, **kwargs):
        server, batcher = create_server(model, *args, **kwargs)
        image = np.full((batcher.height, batcher.width, 3), 0.5, np.float32)
        server.serve_forever = lambda: seen.update(model=model, answer=batcher.infer(image, None))
        return server, batcher

    monkeypatch.setattr(serve, "create_server", one_request)
    args = ["--pretrained", str(checkpoint), "--device", "cpu", "--port", "0", "--resolution", "56",
            "--num_tokens", "36", "--no_fp16", "--no_warmup"]
    result = CliRunner().invoke(serve.command(), ["--int8", *args])
    assert result.exit_code == 0, result.output
    model = seen["model"]
    assert isinstance(model.module.encoder.backbone.blocks[0].attn.qkv, QuantLinear)
    assert set(seen["answer"]) >= {"depth", "intrinsics"} and np.isfinite(seen["answer"]["intrinsics"]).all()

    result = CliRunner().invoke(serve.command(), ["--int8", "--version", "v1", *args])
    assert result.exit_code == 2 and "--int8 is only supported for v2 models" in result.output
