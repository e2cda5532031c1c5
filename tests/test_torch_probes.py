"""The ported TPU probes (moge_tpu_torch/tools: exp_flash_softmax T1,
exp_vpu_ceiling T2, exp_dense_pallas T3-T6): each plain version against the
JAX tool's own Pallas kernel on the same inputs, run in interpret mode on the
CPU, and each tool's measurement rehearsed on the CPU at a tiny size. The
tools under tools/ are loaded by file path (that folder is no package)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from moge_tpu_torch.ops import _build
from moge_tpu_torch.tools import exp_dense_pallas as dense
from moge_tpu_torch.tools import exp_flash_softmax as fs
from moge_tpu_torch.tools import exp_vpu_ceiling as vpu

TOOLS = Path(__file__).resolve().parent.parent / "tools"
# T1's plain version and the Pallas body both take whole key rows, so they
# differ by less than the kernel's tiles allow (fs.REL_TOL): one bf16 step of
# the output (|out| < 1) where p is rounded after other fp32 sums. T2 and
# T3-T6 are held to their tools' REL_TOL, relative to max |want|.
T1_ABS = 4e-3


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"tpu_{name}", TOOLS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@pytest.fixture(scope="module")
def tpu_flash():
    return _tool("exp_flash_softmax")


@pytest.fixture(scope="module")
def tpu_dense():
    return _tool("exp_dense_pallas")


@pytest.mark.parametrize("variant", fs.VARIANTS)
def test_flash_softmax_plain_matches_pallas(tpu_flash, variant):
    n, n_pad, bh = 200, 256, 2
    q, k, v, v_ext, bias = fs.make_inputs(n, "cpu", bh, n_pad)
    vin = v_ext if variant.startswith("mxusum") else v
    with pltpu.force_tpu_interpret_mode():
        call = tpu_flash.build(variant, bh, n_pad, n_pad, 64, 128, jnp.bfloat16, n)
        want = np.asarray(call(_jnp(q), _jnp(k), _jnp(vin), _jnp(bias)), np.float32)
    got = fs.flash_softmax_variant_plain(variant, q, k, vin, bias, n).float().numpy()
    if variant == "noexp":
        assert not want.any() and not got.any()
    else:
        assert np.abs(got - want).max() <= T1_ABS


def _drop_key_tile(variant, k, v, vin, bias, n):
    """The variant's inputs with the real keys 64..127 taken out of the sum."""
    k, vin, bias = k.clone(), vin.clone(), bias.clone()
    if variant.startswith("mxusum"):  # the validity column and V: no weight, no value
        vin[:, 64:128] = 0
    elif variant == "nobias":  # zero keys and values count as pad keys
        k[:, 64:128] = 0
        vin[:, 64:128] = 0
        n -= 64
    else:
        bias[:, 64:128] = float("-inf")
    return k, vin, bias, n


@pytest.mark.parametrize("variant", [v for v in fs.VARIANTS if v != "noexp"])
def test_flash_softmax_tolerance_catches_a_dropped_key_tile(variant):
    """The kernel's tolerance sits below what one 64-key tile left out of
    the sum moves, at the ragged token count chip_smoke.py checks."""
    n = 1201
    q, k, v, v_ext, bias = fs.make_inputs(n, "cpu", bh=2)
    vin = v_ext if variant.startswith("mxusum") else v
    want = fs.flash_softmax_variant_plain(variant, q, k, vin, bias, n).float()
    dropped = fs.flash_softmax_variant_plain(variant, q, *_drop_key_tile(variant, k, v, vin, bias, n)).float()
    assert (dropped - want).abs().max() > 2 * fs.REL_TOL[variant] * want.abs().max()


def test_flash_softmax_wrapper_runs_the_plain_version_on_cpu():
    q, k, v, v_ext, bias = fs.make_inputs(100, "cpu", 1, 128)
    before = _build.read_launches()
    for variant in fs.VARIANTS:
        vin = v_ext if variant.startswith("mxusum") else v
        got = fs.flash_softmax_variant(variant, q, k, vin, bias, 100)
        assert torch.equal(got, fs.flash_softmax_variant_plain(variant, q, k, vin, bias, 100))
    assert _build.read_launches() == before
    with pytest.raises(ValueError):
        fs.flash_softmax_variant("softmax", q, k, v, bias, 100)


@pytest.mark.parametrize("r,length", [(5, 40), (7, 129), (9, 300)])
@pytest.mark.parametrize("variant", ["v1", "v1_unroll", "v2", "bf16"])
def test_dense_plain_matches_pallas(tpu_dense, variant, r, length):
    _, _, _, A, wx, wy = dense.make_problem(r, length, "cpu", seed=length)
    fn = {"v1": tpu_dense.pallas_dense_objective, "v1_unroll": tpu_dense.pallas_dense_objective_unroll,
          "v2": tpu_dense.pallas_dense_objective_v2, "bf16": tpu_dense.pallas_dense_objective_bf16}[variant]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(_jnp(A), _jnp(wx), _jnp(wy), 0.7))
    got = dense.FUNCTIONS[variant](A, wx, wy, 0.7).numpy()  # CPU tensors: the plain version
    assert np.abs(got - want).max() <= dense.REL_TOL * np.abs(want).max()


def test_dense_wrappers_run_the_plain_versions_on_cpu():
    _, _, _, A, wx, wy = dense.make_problem(3, 50, "cpu")
    before = _build.read_launches()
    for variant, fn in dense.FUNCTIONS.items():
        assert torch.equal(fn(A, wx, wy, 1.0), dense.PLAINS[variant](A, wx, wy, 1.0))
    assert _build.read_launches() == before


@pytest.mark.parametrize("r,length,t", [(3, 50, 0.7), (2, 257, 1.0), (1, 1, 0.7)])
def test_dense_serial_plain_adds_in_index_order(r, length, t):
    """T5's plain version is, bit for bit, the fp32 sum in index order of
    terms whose product and difference are rounded once."""
    _, _, _, A, wx, wy = dense.make_problem(r, length, "cpu", seed=length)
    a, x, y = (v.numpy().astype(np.float64) for v in (A, wx, wy))
    want = np.zeros((r, length), np.float32)
    for i in range(length):
        term = np.abs((a * x[:, i:i + 1] - y[:, i:i + 1]).astype(np.float32))
        want += np.minimum(term, np.float32(t))
    assert np.array_equal(dense.dense_objective_serial_plain(A, wx, wy, t).numpy(), want)


@pytest.mark.parametrize("r,length", [(9, 4096), (606, 64)])
def test_dense_tolerance_catches_a_dropped_term(r, length):
    """REL_TOL sits below one term: F short of the first term of each
    candidate is out of tolerance, and the serial sum's drift from the
    pairwise one (the reason T5 has a plain version of its own) is too."""
    _, _, _, A, wx, wy = dense.make_problem(r, length, "cpu", seed=length)
    want = dense.dense_objective_plain(A, wx, wy, 0.7)
    first = (A * wx[:, :1] - wy[:, :1]).abs().clamp_max(0.7)
    tol = dense.REL_TOL * want.abs().max()
    assert ((want - first) - want).abs().max() > tol
    if length == 4096:
        assert (dense.dense_objective_serial_plain(A, wx, wy, 0.7) - want).abs().max() > tol


def test_vpu_ceiling_plain_matches_the_tools_kernel(monkeypatch):
    """The TPU tool's own kernel body, captured from ``pl.pallas_call`` while
    its ``main`` runs (the tool's timing loop then runs a stand-in), is run
    once per kind in interpret mode on the tool's inputs at the full
    256 x 512 x 2000, and held against the plain version."""
    tool = _tool("exp_vpu_ceiling")
    bodies = []

    def capture(kernel, **kwargs):
        bodies.append((kernel, kwargs["out_shape"]))
        return lambda x, y: jnp.zeros_like(x)

    monkeypatch.setattr(pl, "pallas_call", capture)
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)  # the tool's compilation-cache settings
    tool.main()
    monkeypatch.undo()
    assert len(bodies) == 2  # align, then fma
    x, y = vpu.inputs("cpu")
    for (kernel, out_shape), kind in zip(bodies, ("align", "fma")):
        assert out_shape.shape == vpu.SHAPE
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(pl.pallas_call(kernel, out_shape=out_shape)(x.numpy(), y.numpy()))
        got = vpu.vpu_ceiling(x, y, kind).numpy()  # CPU tensors: the plain version
        assert np.abs(got - want).max() <= vpu.REL_TOL * np.abs(want).max(), kind


def test_vpu_ceiling_wrapper_on_cpu():
    x, y = vpu.inputs("cpu", (3, 5))
    before = _build.read_launches()
    assert torch.equal(vpu.vpu_ceiling(x, y, "align", 9), vpu.vpu_ceiling_plain(x, y, "align", 9))
    assert _build.read_launches() == before
    with pytest.raises(ValueError):
        vpu.vpu_ceiling(x, y, "fmax")


def test_probe_tools_rehearse_on_cpu(capsys):
    """Each tool's measurement and command line on the CPU at a tiny size:
    the plain versions, host-clock times, every line naming the CPU."""
    t1 = fs.measure("cpu", n=100, depth=2, reps=1, bh=2)
    assert [r["variant"] for r in t1["rows"]] == [*fs.VARIANTS, "sdpa (library)"]
    assert t1["n_pad"] == 128 and all(r["ms"] > 0 for r in t1["rows"])
    assert next(r for r in t1["rows"] if r["variant"] == "noexp")["max_diff_vs_base"] > 0
    t2 = vpu.measure("cpu", shape=(4, 8), iters=5, reps=1)
    assert [r["kind"] for r in t2] == ["align", "fma"] and t2[0]["elem_iters"] == 160
    table = {"a": (3, 70), "b": (2, 33)}
    t36 = dense.measure("cpu", ("a", "b"), n=1, reps=1, shape_table=table)
    assert [(r["shape"], r["what"]) for r in t36][:5] == [("a", w) for w in ("K4 solve", *dense.VARIANTS)]
    swept = dense.sweep("cpu", "b", n=1, reps=1, shape_table=table)
    assert len(swept) == sum(len(tiles) for _, _, tiles in dense.VARIANTS.values())
    fs.main(["--device", "cpu", "--n", "60", "--depth", "1", "--reps", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2 * len(fs.VARIANTS) + 2 and all(line.startswith("[cpu") for line in out)
