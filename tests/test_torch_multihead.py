"""The port's batched output heads (moge_tpu_torch.models.multihead) against
its sequential heads and against the JAX package's batched heads
(``MOGE_BATCHED_HEADS=1``), on the tiny MoGe-2 config with the same
weights, batch 2, fp32 on the CPU (where the grouped conv runs its plain
version); the batchability rules against JAX's; gradients through the
batched pass."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moge_tpu.models import multihead as jax_multihead
from moge_tpu.models.v2 import MoGeModel as JaxMoGeModel
from moge_tpu_torch.models import multihead
from moge_tpu_torch.models.multihead import heads_batchable
from moge_tpu_torch.models.v2 import MoGeV2
from moge_tpu_torch.ops import _build, conv
from torch_tiny_config import TINY_CONFIG, state_dict_from_jax_params

torch.set_num_threads(1)

TOL = 2e-4  # the JAX package's own batched-vs-sequential tolerance (tests/test_multihead.py)
NUM_TOKENS = 16
HEADS = ("points_head", "normal_head", "mask_head")


def _with_head_resamplers(resamplers):
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in TINY_CONFIG.items()}
    for head in HEADS:
        cfg[head]["resamplers"] = list(resamplers)
    return cfg


CONFIGS = {
    "tiny": TINY_CONFIG,
    # every batchable resampler flavour, the last one folded outside the up2 path
    "shuffle_nearest": _with_head_resamplers(["pixel_shuffle", "nearest", "conv_transpose", "nearest"]),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    cfg = CONFIGS[request.param]
    jm = JaxMoGeModel(cfg, None, dtype=jnp.float32).init_random(seed=0, image_hw=(56, 56))
    sd = state_dict_from_jax_params(cfg, jax.tree.map(np.asarray, jm.params))
    seq, bat = MoGeV2(**cfg, batched_heads=False), MoGeV2(**cfg, batched_heads=True)
    for m in (seq, bat):
        m.load_state_dict(sd, strict=True)
    assert bat.batched_heads and not seq.batched_heads
    return jm, seq, bat


def _image(seed):
    return np.random.default_rng(seed).uniform(0, 1, (2, 56, 112, 3)).astype(np.float32)


def test_batched_heads_match_sequential_and_jax(models, monkeypatch):
    jm, seq, bat = models
    image = _image(1)
    monkeypatch.setenv("MOGE_BATCHED_HEADS", "1")
    want = jm.module.apply({"params": jm.params}, jnp.asarray(image), NUM_TOKENS)
    before = _build.read_launches()
    with torch.inference_mode():
        got_bat = bat(torch.from_numpy(image), NUM_TOKENS, torch.float32)
        got_seq = seq(torch.from_numpy(image), NUM_TOKENS, torch.float32)
        again = bat(torch.from_numpy(image), NUM_TOKENS, torch.float32)  # cached stacked weights
    assert _build.read_launches() == before  # CPU tensors: the plain version, no launch
    assert set(got_bat) == set(got_seq) == set(want)
    for key in want:
        w = np.asarray(want[key], np.float32)
        for got in (got_bat, got_seq):
            np.testing.assert_allclose(got[key].numpy(), w, rtol=TOL, atol=TOL, err_msg=key)
        np.testing.assert_array_equal(again[key].numpy(), got_bat[key].numpy())


def test_batched_heads_follow_parameter_updates(models):
    """The inference cache of the stacked weights is rebuilt when a head's
    parameter changes in place."""
    _, seq, bat = models
    image = torch.from_numpy(_image(2))
    with torch.inference_mode():
        bat(image, NUM_TOKENS, torch.float32)
    with torch.no_grad():
        for m in (seq, bat):
            m.normal_head.res_blocks[1][0].layers[2].bias.add_(0.5)
            m.mask_head.output_blocks[-1].weight.mul_(1.5)
    with torch.inference_mode():
        got, want = bat(image, NUM_TOKENS, torch.float32), seq(image, NUM_TOKENS, torch.float32)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=TOL, atol=TOL, err_msg=key)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fold_padding_changes_no_output(name, monkeypatch):
    """The batched pass pads the folded finest projections to ``FOLD_PAD``
    channels (32, as JAX); padded only to the widest head, it gives the same
    outputs (what ``tools/heads_breakdown.py`` compares on the card)."""
    padded = MoGeV2(**CONFIGS[name], batched_heads=True).init_random(seed=0)
    unpadded = MoGeV2(**CONFIGS[name], batched_heads=True)
    unpadded.load_state_dict(padded.state_dict(), strict=True)
    image = torch.from_numpy(_image(4))
    heads = [getattr(unpadded, h) for h in HEADS]
    widest = max(h.output_blocks[-1].weight.shape[0] for h in heads)
    with torch.inference_mode():
        want = padded(image, NUM_TOKENS, torch.float32)  # stacked weights built with FOLD_PAD = 32
        monkeypatch.setattr(multihead, "FOLD_PAD", 1)
        got = unpadded(image, NUM_TOKENS, torch.float32)
        assert multihead._stacked_weights(heads, torch.float32)["final"][0].shape[-1] == widest < 32
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-5, atol=1e-6, err_msg=key)


def test_gradient_reaches_every_head_parameter(models):
    _, seq, bat = models
    image = torch.from_numpy(_image(3))
    grads = []
    for m in (bat, seq):
        m.zero_grad()
        out = m(image, NUM_TOKENS, torch.float32)
        loss = out["points"].square().mean() + out["normal"][..., 0].mean() + out["mask_logit"].mean()
        loss.backward()
        grads.append({n: p.grad for n, p in m.named_parameters() if n.split(".")[0] in HEADS})
    for name, g in grads[0].items():
        assert g is not None and bool(g.abs().sum() > 0), name
        np.testing.assert_allclose(g.numpy(), grads[1][name].numpy(), rtol=1e-3, atol=1e-6, err_msg=name)


def _head(**overrides):
    return {**TINY_CONFIG["points_head"], **overrides}


BATCHABILITY = [
    [_head(), _head(dim_out=[None] * 4 + [1])],
    [_head()],
    [_head(), _head(res_block_in_norm="layer_norm")],
    [_head(), _head(res_block_hidden_norm="group_norm")],
    [_head(activation="silu"), _head(activation="silu")],
    [_head(), _head(num_res_blocks=[0, 1, 1, 1, 1])],
    [_head(num_res_blocks=[0, 1, 1, 1, 1]), _head(num_res_blocks=[0, 1, 1, 1, 1])],
    [_head(resamplers=["conv_transpose"] * 3 + ["max_pool"])] * 2,
    [_head(resamplers=["pixel_shuffle", "nearest", "bilinear", "conv_transpose"])] * 2,
    [_head(), _head(dim_out=[None, 3, None, None, 3])],
    [_head(), _head(dim_out=[None] * 5)],
    [_head(dim_in=[64, None, 16, 16, 16])] * 2,
    [_head(), _head(dim_times_res_block_hidden=2)],
    [_head(), _head(dim_res_blocks=[64, 32, 16, 16, 8])],
]


def test_heads_batchable_agrees_with_jax(monkeypatch):
    monkeypatch.setenv("MOGE_BATCHED_HEADS", "1")
    verdicts = [heads_batchable(cfgs) for cfgs in BATCHABILITY]
    assert verdicts == [jax_multihead.heads_batchable(cfgs) for cfgs in BATCHABILITY]
    assert True in verdicts and False in verdicts


@pytest.mark.parametrize("env,want", [(None, False), ("0", False), ("false", False), ("", False), ("1", True)])
def test_batched_heads_default_reads_the_environment(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("MOGE_BATCHED_HEADS", raising=False)
    else:
        monkeypatch.setenv("MOGE_BATCHED_HEADS", env)
    assert MoGeV2(**TINY_CONFIG).batched_heads is want
    assert MoGeV2(**TINY_CONFIG, batched_heads=not want).batched_heads is (not want)
