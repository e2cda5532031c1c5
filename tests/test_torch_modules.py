"""The port's decoder pieces (moge_tpu_torch.models.modules) against their
JAX counterparts (moge_tpu.models.modules): every activation, norm and
resampler flavour, the residual block with norms and the skip projection,
the ConvStack fold of the finest output projection, and bicubic
antialiased resizing to a size. Weights cross over through the JAX
package's export helpers (the microsoft/MoGe state-dict names); fp32 on
the CPU, where the kernel wrappers run their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moge_tpu.models.modules as jm
from moge_tpu.models import convert as jconvert
from moge_tpu.ops.resize import resize_2d as jax_resize_2d
from moge_tpu_torch.models import modules as tm
from moge_tpu_torch.ops.resize import resize_2d

torch.set_num_threads(1)

FP32_TOL = 1e-5


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _init(module, seed, *args):
    """JAX params of ``module`` with every leaf perturbed (nonzero biases, non-unit norm scales)."""
    params = module.init(jax.random.PRNGKey(seed), *args).get("params", {})
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32), params)


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, strict=True)
    return module


def _close(got, want, tol=FP32_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["relu", "leaky_relu", "silu", "elu"])
def test_activations_match(name):
    x = _x((4, 5, 6, 7), 0)
    module_cls, fn = tm._activation(name)
    want = jm._activation(name)(jnp.asarray(x))
    _close(fn(torch.from_numpy(x)), want)
    _close(module_cls()(torch.from_numpy(x)), want)
    with pytest.raises(ValueError):
        tm._activation("gelu")


@pytest.mark.parametrize("kind,channels", [("none", 8), ("instance_norm", 8), ("layer_norm", 24), ("group_norm", 64)])
def test_norms_match(kind, channels):
    x = _x((2, 5, 7, channels), channels) * 3 + 1
    mod = jm.Norm2d(kind, channels)
    params = _init(mod, 1, jnp.asarray(x))
    want = mod.apply({"params": params}, jnp.asarray(x))
    sd = {} if not params else {"weight": params["scale"], "bias": params["bias"]}
    port = _load(tm.Norm2d(kind, channels), sd)
    assert len(list(port.parameters())) == len(sd)
    _close(port(torch.from_numpy(x)), want)


def test_norm_statistics_are_fp32_under_bf16():
    """bf16 in and out, statistics in fp32: one rounding of the fp32 result."""
    x = torch.from_numpy(_x((1, 6, 6, 64), 3) * 5 + 2).to(torch.bfloat16)
    norm = tm.Norm2d("group_norm", 64)
    got = norm(x)
    assert got.dtype == torch.bfloat16
    want = norm(x.float())
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert bool(((got.float() - want).abs() <= ulp).all())


@pytest.mark.parametrize("activation,in_norm,hidden_norm,cin,cout,hidden", [
    ("relu", "layer_norm", "group_norm", 32, 32, 64),
    ("leaky_relu", "instance_norm", "layer_norm", 16, 16, 16),
    ("silu", "group_norm", "none", 32, 48, 32),     # skip projection
    ("elu", "none", "instance_norm", 8, 12, 16),    # skip projection
    ("relu", "none", "none", 16, 8, 16),            # skip projection, ReLU fused
])
def test_residual_block_matches(activation, in_norm, hidden_norm, cin, cout, hidden):
    x = _x((2, 6, 5, cin), cin + cout)
    mod = jm.ResidualConvBlock(in_channels=cin, out_channels=cout, hidden_channels=hidden, activation=activation,
                               in_norm=in_norm, hidden_norm=hidden_norm)
    params = _init(mod, 2, jnp.asarray(x))
    want = mod.apply({"params": params}, jnp.asarray(x))
    sd = {}
    jconvert._res_block_inv(sd, "", params)
    port = _load(tm.ResidualConvBlock(cin, cout, hidden, activation, in_norm, hidden_norm), sd)
    assert hasattr(port, "skip_connection") == (cin != cout)
    _close(port(torch.from_numpy(x)), want)


def _fold(o, p, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((o, p)).astype(np.float32) * o ** -0.5, rng.standard_normal(p).astype(np.float32)


@pytest.mark.parametrize("type_", tm.RESAMPLERS)
@pytest.mark.parametrize("fold", [False, True], ids=["plain", "fold"])
def test_resamplers_match(type_, fold):
    cin, cout, p = 8, 12, 5
    x = _x((2, 6, 4, cin), 7)
    mod = jm.Resampler(in_channels=cin, out_channels=cout, type_=type_)
    params = _init(mod, 3, jnp.asarray(x))
    sd = {}
    jconvert._resampler_inv(sd, "", params, type_)
    port = _load(tm.Resampler(cin, cout, type_), sd)
    fold_mod = None
    kwargs = {}
    if fold:
        fw, fb = _fold(cout, p, 9)
        kwargs = {"fold_w": jnp.asarray(fw), "fold_b": jnp.asarray(fb)}
        fold_mod = _load(tm.Conv1x1(cout, p), {"weight": fw.T[:, :, None, None], "bias": fb})
    if fold and type_ == "max_pool":
        with pytest.raises(ValueError):
            port(torch.from_numpy(x), fold=fold_mod)
        return
    want = mod.apply({"params": params}, jnp.asarray(x), **kwargs)
    got = port(torch.from_numpy(x), fold=fold_mod)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def _conv_stack_cfg(last_resampler, n_last_res=0):
    return {"dim_in": [16, 2, 2], "dim_res_blocks": [16, 16, 8], "dim_out": [None, None, 3],
            "num_res_blocks": [1, 1, n_last_res], "resamplers": ["conv_transpose", last_resampler],
            "res_block_in_norm": "none", "res_block_hidden_norm": "none"}


def _conv_stacks(cfg, dtype):
    last = (3, 4) if cfg["resamplers"][-1] in ("pixel_unshuffle", "avg_pool", "max_pool") else (12, 16)
    feats = [_x((2, 3, 4, 16), 1), _x((2, 6, 8, 2), 2), _x((2, *last, 2), 3)]
    mod = jm.ConvStack(**cfg, dtype=dtype)
    params = _init(mod, 4, [jnp.asarray(f) for f in feats])
    sd = {}
    jconvert.export_conv_stack(sd, "", params, cfg)
    port = _load(tm.ConvStack(**cfg), sd)
    return mod, params, port, feats


@pytest.mark.parametrize("last", tm.RESAMPLERS)
def test_conv_stack_folds_the_finest_projection_like_jax(last):
    """The finest output projection folds into the last resampler's conv for
    every type but max_pool, as the JAX ConvStack does (fp32 parity)."""
    cfg = _conv_stack_cfg(last)
    mod, params, port, feats = _conv_stacks(cfg, jnp.float32)
    assert port.fuse_last == (last != "max_pool")
    want = mod.apply({"params": params}, [jnp.asarray(f) for f in feats])
    got = port([torch.from_numpy(f) for f in feats])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("last", ["conv_transpose", "nearest"])
def test_conv_stack_bf16_matches_jax_within_one_rounding(last):
    """bf16: the folded conv rounds once, as JAX's does, so the finest
    output agrees within one bf16 ulp (an unfolded projection would round
    the 8-channel intermediate and the 3-channel output, several ulps)."""
    cfg = _conv_stack_cfg(last)
    mod, params, port, feats = _conv_stacks(cfg, jnp.bfloat16)
    want = np.asarray(mod.apply({"params": params}, [jnp.asarray(f) for f in feats])[-1].astype(jnp.float32))
    with torch.no_grad():
        got = port([torch.from_numpy(f).to(torch.bfloat16) for f in feats])[-1].float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.mean(np.abs(got - want) <= ulp + 1e-6) >= 0.98


@pytest.mark.parametrize("in_hw,out_hw", [((37, 53), (20, 31)), ((20, 31), (45, 64)), ((64, 48), (33, 33))])
@pytest.mark.parametrize("antialias", [True, False])
def test_bicubic_resize_to_a_size_matches(in_hw, out_hw, antialias):
    x = _x((2, *in_hw, 3), sum(in_hw))
    want = jax_resize_2d(jnp.asarray(x), out_hw, mode="bicubic", antialias=antialias)
    got = resize_2d(torch.from_numpy(x), out_hw, mode="bicubic", antialias=antialias)
    assert tuple(got.shape) == (2, *out_hw, 3)
    _close(got, want)


def test_conv_kxk_matches_jax_conv2d():
    for k in (1, 5):
        x = _x((2, 7, 6, 8), k)
        mod = jm.Conv2d(features=4, kernel_size=k)
        params = _init(mod, 5, jnp.asarray(x))
        want = mod.apply({"params": params}, jnp.asarray(x))
        sd = {}
        jconvert._conv_inv(sd, "", params["conv"])
        port = _load(tm.conv2d(8, 4, k), sd)
        assert isinstance(port, tm.Conv1x1 if k == 1 else tm.ConvKxK)
        _close(port(torch.from_numpy(x)), want)
