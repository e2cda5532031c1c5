"""The port's train step (moge_tpu_torch.train) against the JAX package:
LR schedules, AdamW with fnmatch param groups, a frozen group and the
global-norm clip against optax; the NaN-gradient skip and the EMA against
``make_apply_step``; and one whole ``make_train_step`` on the tiny MoGe-2 of
``__graft_entry__.dryrun_multichip`` (loss, metrics, updated parameters and
EMA) with the same weights and batch, fp32 on the CPU. The loss config of
the whole step has no local losses, so no random draw enters; the local
losses are held against JAX with injected draws in test_torch_losses.py."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from moge_tpu.models.v2 import MoGeV2 as JaxMoGeV2
from moge_tpu.train import step as jstep
from moge_tpu.train import utils as jutils
from moge_tpu_torch.models.v2 import MoGeV2
from moge_tpu_torch.train import step as tstep
from moge_tpu_torch.train import utils as tutils
from torch_tiny_config import TINY_CONFIG, state_dict_from_jax_params

torch.set_num_threads(1)

V2 = json.loads((Path(__file__).resolve().parent.parent / "configs/train/v2.json").read_text())
# optax's float32 bias correction 1 - 0.999**t is 1.3e-5 off the nominal one
# the port uses, so each update of size lr differs by ~7e-6 * lr: two
# updates at lr 0.1 stay within 2e-6
OPT_TOL = 2e-6
# whole step at lr 1e-4 / 1e-5: a twentieth of the larger lr catches a missing
# or reversed update and tolerates the few components whose gradient is near
# Adam's eps, where the update's size follows the gradient's last digits
STEP_TOL = 5e-6

_OPT_CFG = {"type": "AdamW", "params": [
    {"params": {"include": ["*"], "exclude": ["*.backbone.*", "*frozen*"]}, "lr": 1e-1},
    {"params": {"include": ["*.backbone.*"]}, "lr": 1e-3, "weight_decay": 0.1, "betas": [0.8, 0.99]}]}
_SCHED = {"type": "LambdaLR", "params": {"lr_lambda": ["0.5 ** epoch", "1.0 + epoch"]}}


@pytest.mark.parametrize("group", [0, 1])
def test_v2_lr_schedule_matches_jax(group):
    want = jutils.build_lr_schedule(V2["lr_scheduler"], group)
    got = tutils.build_lr_schedule(V2["lr_scheduler"], group)
    for step in (0, 1, 999, 1000, 1500, 1999, 2000, 2001, 26999, 27000, 80000):
        assert got(step) == pytest.approx(float(want(jnp.asarray(step))), rel=1e-6), step


class _Tree(nn.Module):
    """A module whose parameter names are the dotted paths of a nested dict."""

    def __init__(self, tree):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, _Tree(value))
            else:
                self.register_parameter(key, nn.Parameter(torch.from_numpy(np.array(value))))


def _tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"encoder": {"backbone": {"w": f(4, 3), "b": f(3)}, "proj": {"w": f(3, 2)}},
            "neck": {"w": f(5)}, "frozen": {"w": f(2, 2)}}


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + key + ".")
        else:
            yield prefix + key, value


def _assert_tree_equal(module, tree, tol):
    got = dict(module.named_parameters())
    for name, want in _flat(tree):
        np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(want), rtol=tol, atol=tol, err_msg=name)


def test_optimizer_matches_optax():
    """Two AdamW updates: the first with gradients whose global norm is 40
    (clipped), the second under the clip; per-group lr, betas and weight
    decay; the schedule advancing once per update; an unmatched (frozen)
    group whose gradient still counts in the clip's norm."""
    params = _tree(0)
    module = _Tree(params)
    tx_j = jutils.build_optimizer(params, _OPT_CFG, _SCHED)
    tx_t = tutils.build_optimizer(module, _OPT_CFG, _SCHED)
    assert tx_t.groups == [["encoder.proj.w", "neck.w"], ["encoder.backbone.w", "encoder.backbone.b"]]
    state = tx_j.init(params)
    for i, norm in enumerate((40.0, 0.3)):
        grads = jax.tree.map(lambda p: np.random.default_rng(i + p.size).standard_normal(p.shape).astype(np.float32),
                             params)
        gnorm = float(optax.global_norm(grads))
        grads = jax.tree.map(lambda g: g * np.float32(norm / gnorm), grads)
        updates, state = tx_j.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        tx_t.step({n: torch.from_numpy(np.array(g)) for n, g in _flat(grads)})
        _assert_tree_equal(module, params, OPT_TOL)
    assert tx_t.count == 2
    assert tx_t.lrs() == pytest.approx([0.1 * 0.25, 1e-3 * 3.0])


def test_apply_step_nan_skip_and_ema_match_jax():
    """A finite update, then a NaN gradient: the parameters and the optimizer
    state (schedule count included) stay; the EMA and the step count move."""
    params = _tree(1)
    module = _Tree(params)
    tx_j = jutils.build_optimizer(params, _OPT_CFG, _SCHED)
    tx_t = tutils.build_optimizer(module, _OPT_CFG, _SCHED)
    state_j = jstep.init_train_state(params, tx_j)
    state_t = tstep.init_train_state(module, tx_t)
    apply_j, apply_t = jstep.make_apply_step(tx_j), tstep.make_apply_step(tx_t)
    good = jax.tree.map(lambda p: np.full(p.shape, 0.1, np.float32), params)
    bad = jax.tree.map(lambda g: g.copy(), good)
    bad["neck"]["w"][2] = np.nan
    for grads, ok in ((good, True), (bad, False), (good, True)):
        state_j, ok_j = apply_j(state_j, grads)
        state_t, ok_t = apply_t(state_t, {n: torch.from_numpy(np.array(g)) for n, g in _flat(grads)})
        assert bool(ok_j) == ok_t == ok
        _assert_tree_equal(module, state_j.params, OPT_TOL)
        for name, want in _flat(state_j.ema_params):
            if not name.startswith("frozen"):  # the port's EMA covers the trainable parameters
                np.testing.assert_allclose(state_t.ema_params[name].numpy(), np.asarray(want), rtol=OPT_TOL,
                                           atol=OPT_TOL)
    assert state_t.step == int(state_j.step) == 3
    assert tx_t.count == 2


_LOSS_CONFIG = {
    "invalid": {},
    "A": {
        "global": {"function": "affine_invariant_global_loss", "weight": 1.0, "params": {"align_resolution": 12}},
        "normal": {"function": "edge_loss", "weight": 1.0},
        "normal_map": {"function": "normal_map_loss", "weight": 0.1},
        "metric_scale": {"function": "metric_scale_loss", "weight": 0.1},
        "mask": {"function": "mask_bce_loss", "weight": 0.1},
    },
    "B": {
        "global": {"function": "affine_invariant_global_loss", "weight": 1.0, "params": {"align_resolution": 12}},
        "mask": {"function": "mask_bce_loss", "weight": 0.1},
    },
}
_LABEL_TYPES = ["invalid", "A", "B"]
_DRYRUN_OPT = {"type": "AdamW", "params": [
    {"params": {"include": ["*"], "exclude": ["*.backbone.*"]}, "lr": 1e-4},
    {"params": {"include": ["*.backbone.*"]}, "lr": 1e-5}]}


def _batch(b=2, h=56, w=56, seed=0):
    """As ``__graft_entry__.dryrun_multichip`` makes it."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1, 5, (b, h, w)).astype(np.float32)
    return {
        "image": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
        "depth": depth,
        "normal": rng.standard_normal((b, h, w, 3)).astype(np.float32),
        "normal_mask": np.ones((b, h, w), bool),
        "depth_mask_fin": rng.uniform(0, 1, (b, h, w)) > 0.1,
        "depth_mask_inf": np.zeros((b, h, w), bool),
        "intrinsics": np.broadcast_to(np.asarray([[1.0, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1.0]], np.float32),
                                      (b, 3, 3)).copy(),
        "label_type_idx": np.asarray([1, 2], np.int32),
        "is_metric": np.ones((b,), bool),
    }


@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step of the tiny MoGe-2: (params before, state after, metrics)."""
    module = JaxMoGeV2(**TINY_CONFIG, dtype=jnp.float32)
    params = jax.jit(module.init, static_argnums=(2,))(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)), 16)["params"]
    params = jax.tree.map(np.asarray, params)
    tx = jutils.build_optimizer(params, _DRYRUN_OPT, V2["lr_scheduler"])
    step = jax.jit(jstep.make_train_step(module, tx, _LOSS_CONFIG, _LABEL_TYPES, 16))
    state, metrics = step(jstep.init_train_state(params, tx), {k: jnp.asarray(v) for k, v in _batch().items()},
                          jax.random.PRNGKey(1))
    return params, state, {k: float(v) for k, v in metrics.items()}


def _sd(state_dict_like):
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v for k, v in state_dict_like.items()}


def test_train_step_matches_jax(jax_step):
    params, state_j, metrics_j = jax_step
    module = MoGeV2(**TINY_CONFIG)
    module.load_state_dict(state_dict_from_jax_params(TINY_CONFIG, params), strict=True)
    tx = tutils.build_optimizer(module, _DRYRUN_OPT, V2["lr_scheduler"])
    state = tstep.init_train_state(module, tx)
    step = tstep.make_train_step(module, tx, _LOSS_CONFIG, _LABEL_TYPES, 16, dtype=torch.float32)
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in _batch().items()}, torch.Generator())
    assert set(metrics) == set(metrics_j)
    for k, want in metrics_j.items():
        assert float(metrics[k]) == pytest.approx(want, rel=1e-4, abs=1e-6), k
    assert state.step == 1 and tx.count == 1

    want = state_dict_from_jax_params(TINY_CONFIG, jax.tree.map(np.asarray, state_j.params))
    want_ema = state_dict_from_jax_params(TINY_CONFIG, jax.tree.map(np.asarray, state_j.ema_params))
    got = _sd(module.state_dict())
    before = state_dict_from_jax_params(TINY_CONFIG, params)
    for name, p in module.named_parameters():
        if not p.requires_grad:
            continue
        np.testing.assert_allclose(got[name], want[name].numpy(), rtol=0, atol=STEP_TOL, err_msg=name)
        np.testing.assert_allclose(state.ema_params[name].numpy(), want_ema[name].numpy(), rtol=0, atol=STEP_TOL,
                                   err_msg=name)
        # the v2 schedule starts the backbone at lr 0: everything else moves, in both packages
        moved = not np.array_equal(got[name], before[name].numpy())
        assert moved == (not name.startswith("encoder.backbone.")) == (not torch.equal(want[name], before[name]))


def test_accumulated_half_batches_equal_the_full_batch():
    """accumulate_grads + scale_grads over two half-batches give the full
    batch's gradients (each loss is a mean over instances)."""
    module = MoGeV2(**TINY_CONFIG).init_random(seed=0)
    grad_step = tstep.make_grad_step(module, _LOSS_CONFIG, _LABEL_TYPES, 16, dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in _batch(b=2).items()}
    full, _ = grad_step(batch, torch.Generator())
    halves = [grad_step({k: v[i:i + 1] for k, v in batch.items()}, torch.Generator())[0] for i in range(2)]
    mean = tstep.scale_grads(tstep.accumulate_grads(*halves), 2.0)
    for name, g in full.items():
        torch.testing.assert_close(mean[name], g, rtol=1e-4, atol=1e-6 * g.abs().max().item() + 1e-12)
