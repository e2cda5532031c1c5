"""Export (``moge_tpu_torch.models.export``) on the CPU, tiny MoGe-2 and
MoGe-1 with JAX random inits bridged into the port: the raw forward's
artifact against JAX's ``forward`` (JAX's own export test's tolerance,
rtol 1e-3 / atol 1e-5) and the port's live forward (1e-6); the whole
``infer`` (``with_postprocess``, camera solve inside) at batch 2 against
JAX's ``infer`` and the port's live ``infer`` at
``test_torch_model_v2.py::test_infer_matches_jax``'s tolerances; the graph's
``moge::*`` op nodes in the counts the config implies and no node that
recomputes a weight; the bytes loaded in a fresh process that imports only
``moge_tpu_torch.models.export``; a MoGe-1 ``with_postprocess`` export
refused."""

import io
import operator
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import expected_launches, expected_v1_launches
from moge_tpu.models.v1 import MoGeModel as JaxMoGeV1
from moge_tpu.models.v2 import MoGeModel as JaxMoGeV2, apply_epilogue as jax_apply_epilogue
from moge_tpu_torch.models import v1, v2
from moge_tpu_torch.models.export import export_program, load_program
from torch_tiny_config import TINY_CONFIG, state_dict_from_jax_params, v1_state_dict_from_jax_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TINY_V1 = {"encoder": "dinov2_vitt14", "intermediate_layers": 4, "dim_proj": 32, "dim_upsample": [32, 16, 16],
           "dim_times_res_block_hidden": 2, "num_res_blocks": 1, "remap_output": "exp",
           "res_block_norm": "group_norm", "last_res_blocks": 1, "last_conv_channels": 32, "last_conv_size": 1}
JAX_RTOL, JAX_ATOL = 1e-3, 1e-5  # tests/test_export_stablehlo.py: the artifact against the live model
LIVE_TOL = 1e-6
OUT_RTOL, MASK_BAND = 1e-3, 1e-4  # test_torch_model_v2.py::test_infer_matches_jax
H, W = 56, 70


@pytest.fixture(scope="module")
def models():
    jm2 = JaxMoGeV2(TINY_CONFIG, None, dtype=jnp.float32).init_random(seed=0, image_hw=(56, 56))
    tm2 = v2.MoGeModel(TINY_CONFIG, "cpu", torch.float32)
    tm2.module.load_state_dict(state_dict_from_jax_params(TINY_CONFIG, jax.tree.map(np.asarray, jm2.params)))
    jm1 = JaxMoGeV1(TINY_V1, None, dtype=jnp.float32).init_random(seed=0, image_hw=(56, 56))
    tm1 = v1.MoGeModel(TINY_V1, "cpu", torch.float32)
    tm1.module.load_state_dict(v1_state_dict_from_jax_params(TINY_V1, jax.tree.map(np.asarray, jm1.params)))
    tm2b = v2.MoGeModel(TINY_CONFIG, "cpu", torch.bfloat16, batched_heads=True)  # with_postprocess's bf16
    tm2b.module.load_state_dict(tm2.module.state_dict())
    return {"v2": (jm2, tm2, 16), "v1": (jm1, tm1, 36), "v2 batched heads": (jm2, tm2b, 16)}


def _image(batch, seed):
    return np.random.default_rng(seed).uniform(0, 1, (batch, H, W, 3)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_raw_forward_artifact(models, version):
    jm, tm, tokens = models[version]
    image = _image(1, 0)
    blob = export_program(tm, H, W, tokens)
    assert isinstance(blob, bytes) and len(blob) > 1000
    got = load_program(blob)(torch.from_numpy(image))
    want_jax = jm.forward(jnp.asarray(image), tokens)
    with torch.no_grad():
        want_live = tm.module(torch.from_numpy(image), tokens, torch.float32)
    assert set(got) == set(want_jax) == set(want_live)
    for key in want_jax:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want_jax[key]), rtol=JAX_RTOL, atol=JAX_ATOL,
                                   err_msg=key)
        np.testing.assert_allclose(got[key].numpy(), want_live[key].numpy(), rtol=LIVE_TOL, atol=LIVE_TOL,
                                   err_msg=key)


def test_infer_artifact(models):
    """The camera solve runs inside the artifact: its outputs (batch 2, fp32)
    against JAX's ``infer`` and the port's live ``infer``."""
    jm, tm, tokens = models["v2"]
    image = _image(2, 1)
    got = load_program(export_program(tm, H, W, tokens, batch=2, with_postprocess=True, use_fp16=False))(
        torch.from_numpy(image))
    live = tm.infer(image, num_tokens=tokens, use_fp16=False)
    want = jm.infer(image, num_tokens=tokens, use_fp16=False)
    assert set(got) == set(live) == set(want) == {"points", "depth", "intrinsics", "mask", "normal"}
    assert bool(torch.isfinite(got["intrinsics"]).all())
    bh, bw = v2.base_token_grid(tokens, W / H)
    raw = jm._decode_fn(bh, bw, jnp.float32)(jm.params, jm._resize_in_fn(bh, bw)(jnp.asarray(image)),
                                             jnp.float32(W / H))
    settled = np.abs(np.asarray(jax_apply_epilogue(raw, H, W, "exp")["mask"]) - 0.5) > MASK_BAND
    for reference in (live, want):
        ref = {k: np.asarray(v) for k, v in reference.items()}
        mask = got["mask"].numpy()
        np.testing.assert_array_equal(mask[settled], ref["mask"][settled])
        agree = mask == ref["mask"]
        assert _rel(got["intrinsics"].numpy(), ref["intrinsics"]) <= OUT_RTOL
        for key in ("points", "depth", "normal"):
            a, b = got[key].numpy(), ref[key]
            sel = agree if a.ndim == 3 else agree[..., None].repeat(3, -1)
            np.testing.assert_array_equal(np.isfinite(a[sel]), np.isfinite(b[sel]))
            fin = sel & np.isfinite(b)
            assert _rel(a[fin], b[fin]) <= OUT_RTOL, key


def _derived_tensors(module):
    """Every tensor of the derived-weight caches under ``module``."""
    def walk(value):
        if isinstance(value, torch.Tensor):
            yield value
        elif isinstance(value, (tuple, list)):
            for v in value:
                yield from walk(v)
        elif isinstance(value, dict):
            for v in value.values():
                yield from walk(v)

    for sub in module.modules():
        for _stamp, value in sub.__dict__.get("_derived", {}).values():
            yield from walk(value)


def _weight_derived_nodes(program, weights):
    """Compute nodes (not views, aliases, tuple items or metadata asserts) whose inputs all
    derive from weight constants alone: work an artifact would redo on every
    call to rebuild a derived weight. Returns their count and the number of
    weight constants."""
    from torch.export.graph_signature import InputKind

    specs = program.graph_signature.input_specs
    const = {s.arg.name: program.constants[s.target] for s in specs if s.kind == InputKind.CONSTANT_TENSOR}
    pure = {node for node in program.graph.nodes if node.op == "placeholder" and node.name in const
            and any(const[node.name].shape == w.shape and const[node.name].dtype == w.dtype
                    and torch.equal(const[node.name], w) for w in weights)}
    count = 0
    for node in program.graph.nodes:
        if node.op == "call_function" and node.all_input_nodes and all(a in pure for a in node.all_input_nodes):
            pure.add(node)
            returns = [] if node.target is operator.getitem else node.target._schema.returns
            count += bool(returns) and all(r.alias_info is None for r in returns)
    return count, sum(node.op == "placeholder" for node in pure)


@pytest.mark.parametrize("version,post,fp16", [("v2", False, False), ("v2", True, True), ("v1", False, True),
                                              ("v2 batched heads", True, True)])
def test_graph_holds_the_ops_and_the_weights_as_constants(models, version, post, fp16):
    """One op node per kernel call of the forward (chip_smoke's launch
    counts of the config; the batched heads' grouped convs are
    ``moge::conv3x3`` with 5-dim kernels; with ``infer``'s post-processing
    the camera solve is one ``moge::camera_solve``), and the derived weights (bf16
    casts, folds, parity expansions, the heads' stacks, the pos-embed grid)
    as constants: no node rebuilds one from the parameters. The program's
    outputs equal the live model's."""
    _, tm, tokens = models[version]
    blob = export_program(tm, H, W, tokens, with_postprocess=post, use_fp16=fp16)
    program = torch.export.load(io.BytesIO(blob))
    ops = Counter(str(n.target) for n in program.graph.nodes if str(n.target).startswith("moge."))
    expect = (expected_v1_launches(TINY_V1) if version == "v1"
              else expected_launches(TINY_CONFIG, batched_heads=tm.module.batched_heads))
    assert ops == {"moge.layer_norm.default": expect["layer_norm"],
                   "moge.flash_attention.default": expect["flash_attention"],
                   "moge.conv3x3.default": expect["conv3x3"] + expect["conv3x3_grouped"],
                   **({"moge.camera_solve.default": expect["camera_solve"]} if post else {})}
    image = torch.from_numpy(_image(1, 3))
    got = load_program(blob)(image)
    if post:
        want = tm.infer(image, num_tokens=tokens, use_fp16=fp16)
    else:
        with torch.no_grad():
            want = tm.module(image, tokens, tm.dtype if fp16 else torch.float32)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    weights = [*tm.module.parameters(), *tm.module.buffers(), *_derived_tensors(tm.module)]
    derived_nodes, weight_constants = _weight_derived_nodes(program, weights)
    assert weight_constants > 50 and derived_nodes == 0


def test_artifact_loads_in_a_fresh_process(models, tmp_path):
    _, tm, tokens = models["v2"]
    (tmp_path / "m.pt2").write_bytes(export_program(tm, H, W, tokens, with_postprocess=True, use_fp16=False))
    image = torch.from_numpy(_image(1, 2))
    torch.save(image, tmp_path / "image.pt")
    code = ("import sys, torch\n"
            "torch.set_num_threads(1)  # as here: a CPU reduction's split follows the thread count\n"
            "from moge_tpu_torch.models.export import load_program\n"
            f"program = load_program(open({str(tmp_path / 'm.pt2')!r}, 'rb').read())\n"
            f"torch.save(program(torch.load({str(tmp_path / 'image.pt')!r})), {str(tmp_path / 'out.pt')!r})\n"
            "assert not [m for m in ('jax', 'moge_tpu') if m in sys.modules]\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=300)
    got = torch.load(tmp_path / "out.pt")
    want = load_program((tmp_path / "m.pt2").read_bytes())(image)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_moge1_with_postprocess_is_refused(models):
    _, tm, tokens = models["v1"]
    with pytest.raises(ValueError, match="--with_postprocess export requires a MoGe-2 model"):
        export_program(tm, H, W, tokens, with_postprocess=True)
