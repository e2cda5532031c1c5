"""MoGe-1 training on the port: one grad step of a tiny MoGe-1 on
``configs/train/v1.json``'s loss tables (solves cut to the CPU's size)
against the JAX package's ``make_grad_step`` on its v1 module, with the same
weights (``export_moge1``), batch, random draws (JAX's, injected through
``losses.draw``) and ReLU branches (JAX's, where an input within rounding of
0 went the other way), fp32 on the CPU; then the ``train`` command on a v1 config
over the synthetic datasets: the checkpoint it writes loads through
``models.v1.MoGeModel.from_pretrained`` and runs ``infer``, and the hub graft
of ``--backbone_checkpoint`` reaches MoGe-1's backbone."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moge_tpu.models import modules as jmod
from moge_tpu.models import v1 as jv1
from moge_tpu.models.v1 import MoGeModel as JaxMoGeModel
from moge_tpu.train import step as jstep
from moge_tpu.train import utils as jutils
from moge_tpu.ops import geometry as jgeo
from moge_tpu_torch.models import modules as tmodules
from moge_tpu_torch.models.dinov2 import VIT_ARCHS, DinoVisionTransformer
from moge_tpu_torch.models.modules import init_params
from moge_tpu_torch.models.v1 import MoGeModel, MoGeV1
from moge_tpu_torch.scripts import cli
from moge_tpu_torch.train import losses
from moge_tpu_torch.train import step as tstep
from moge_tpu_torch.train import utils as tutils
from test_torch_losses import _jax_local_draws
from test_torch_train import STEP_TOL
from torch_tiny_config import v1_state_dict_from_jax_params, write_train_dataset

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
V1 = json.loads((ROOT / "configs/train/v1.json").read_text())
TINY_V1 = {"encoder": "dinov2_vitt14", "intermediate_layers": 4, "dim_proj": 32, "dim_upsample": [32, 16, 16],
           "dim_times_res_block_hidden": 2, "num_res_blocks": 1, "remap_output": "exp",
           "res_block_norm": "group_norm", "last_res_blocks": 1, "last_conv_channels": 32, "last_conv_size": 1,
           "num_tokens_range": [16, 36]}
NUM_TOKENS = 36
# tests/test_torch_train.py's tolerance of the whole v2 step's metrics
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-6
# the gradients, on JAX's ReLU branches (v1_steps): the accumulated half
# batches' rtol, and an atol of 1e-4 of each tensor's largest element (JAX's
# CPU forward is ~2e-5 off a float64 one; they part by up to 2.4e-5 here)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4


def _loss_config():
    """v1.json's loss tables with the solves cut to 8/6/4/2 anchors a side
    and 4/16/64 patches per image (test_torch_train_cli's cut)."""
    loss = copy.deepcopy(V1["loss"])
    for table in loss.values():
        for name, res, patches in (("global", 8, None), ("patch_4", 6, 4), ("patch_16", 4, 16), ("patch_64", 2, 64)):
            if name in table:
                table[name]["params"]["align_resolution"] = res
                if patches:
                    table[name]["params"]["num_patches"] = patches
    return loss


def _batch(label_types, b=2, h=56, w=56, seed=0):
    """As ``__graft_entry__.dryrun_multichip`` makes it, smooth depth (so the
    local losses find neighbours), label types synthetic and sfm."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    depth = np.stack([2 + 0.5 * np.sin(3 * xx + i) + 0.3 * yy for i in range(b)]).astype(np.float32)
    return {
        "image": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
        "depth": depth,
        "normal": rng.standard_normal((b, h, w, 3)).astype(np.float32),
        "normal_mask": np.ones((b, h, w), bool),
        "depth_mask_fin": rng.uniform(0, 1, (b, h, w)) > 0.1,
        "depth_mask_inf": np.zeros((b, h, w), bool),
        "intrinsics": np.broadcast_to(np.asarray([[1.0, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1.0]], np.float32),
                                      (b, 3, 3)).copy(),
        "label_type_idx": np.asarray([label_types.index("synthetic"), label_types.index("sfm")], np.int32),
        "is_metric": np.zeros((b,), bool),
    }


def _jax_grad_step_with_relu_inputs(module, loss, label_types, mp):
    """JAX's ``make_grad_step`` that also returns the input of every ReLU of
    the forward it differentiates, in call order: the convs' fused input
    ReLUs and the output blocks' ReLU (recorded through ``mp``)."""
    captured = []
    conv_call = jmod.Conv2d.__call__

    def conv(self, x, residual=None, input_relu=False, *args, **kwargs):
        if input_relu:
            captured.append(x)
        return conv_call(self, x, residual, input_relu, *args, **kwargs)

    relu = jv1.nn.relu
    mp.setattr(jmod.Conv2d, "__call__", conv)
    mp.setattr(jv1.nn, "relu", lambda x: captured.append(x) or relu(x))

    def grad_step(params, batch, rng):
        def loss_fn(params):
            captured.clear()
            output = module.apply({"params": params}, batch["image"], NUM_TOKENS)
            total, metrics = jstep.compute_losses(rng, output, batch, loss, label_types)
            return total, (metrics, list(captured))

        (_, (metrics, relu_inputs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return grads, metrics, relu_inputs

    return jax.jit(grad_step)


@pytest.fixture(scope="module")
def v1_steps():
    """One grad step on every loss of v1.json's synthetic and sfm tables
    (global, three local levels with separate solves, normal, mask_l2) in
    both packages from the same weights and batch, the port drawing JAX's
    anchors and taking the branch JAX's forward took at each ReLU. A ReLU
    input within fp32 rounding of 0 goes either way:
    JAX's CPU forward is ~2e-5 off a float64 one where the port's is
    ~5e-6, and on this batch JAX's took the other branch at 3 of the
    head's activations (|input| < 1e-5), which moved its gradients by up to
    0.23% of each tensor's largest element on an x86 CPU. Returns (JAX: grads, metrics;
    the port: module, grads, metrics, the ReLU inputs where the port's own
    branch differs). JAX's side also carries the parameters it started from."""
    loss = _loss_config()
    label_types = sorted(loss)
    batch = _batch(label_types, h=112, w=112)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MOGE_ANCHOR_WEIGHT_IMPL", "shift")
        jm = JaxMoGeModel(TINY_V1, None, dtype=jnp.float32).init_random(seed=0, image_hw=(56, 56))
        params = jax.tree.map(np.asarray, jm.params)
        rng_key = jax.random.PRNGKey(3)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        grads_j, metrics_j = jax.jit(jstep.make_grad_step(jm.module, loss, label_types, NUM_TOKENS))(
            params, jbatch, rng_key)
        recorded = _jax_grad_step_with_relu_inputs(jm.module, loss, label_types, mp)(params, jbatch, rng_key)
        # the recording program computes JAX's gradients bit for bit
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(grads_j), jax.tree.leaves(recorded[0])))
        branches = [torch.from_numpy(np.asarray(x) > 0) for x in recorded[2]]

        # JAX's draws: one key split off the chain per local entry, in entry order
        gt = jnp.where(jbatch["depth_mask_fin"][..., None],
                       jgeo.depth_map_to_point_map(jbatch["depth"], jbatch["intrinsics"]), jnp.inf)
        focal = 1.0 / jnp.sqrt(1.0 / jbatch["intrinsics"][:, 0, 0] ** 2 + 1.0 / jbatch["intrinsics"][:, 1, 1] ** 2)
        draws, chain = [], rng_key
        for name in ("patch_4", "patch_16", "patch_64"):
            spec = loss["synthetic"][name]["params"]
            chain, sub = jax.random.split(chain)
            draws += _jax_local_draws(sub, gt, focal, spec["level"], spec["num_patches"])
        queue = list(draws)
        mp.setattr(losses, "draw", lambda gen, what, arg, size: torch.from_numpy(queue.pop(0).astype(np.int64)))

        # the port on JAX's branches: each ReLU input masked by JAX's sign
        departed = []

        def on_jax_branch(x):
            jax_side = branches.pop(0)
            departed.append(x.detach()[(x.detach() > 0) != jax_side])
            return x * jax_side

        conv = tmodules.conv3x3_replicate
        mp.setattr(tmodules, "conv3x3_replicate", lambda x, kernel, bias, residual=None, input_relu=False: conv(
            on_jax_branch(x) if input_relu else x, kernel, bias, residual, False))
        module = MoGeV1(**TINY_V1)
        module.load_state_dict(v1_state_dict_from_jax_params(TINY_V1, params), strict=True)
        for relu in [m for m in module.modules() if isinstance(m, torch.nn.ReLU)]:
            relu.register_forward_hook(lambda m, inputs, out: on_jax_branch(inputs[0]))
        grads_t, metrics_t = tstep.make_grad_step(module, loss, label_types, NUM_TOKENS, torch.float32)(
            {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator())
        assert not queue and not branches
    return (grads_j, metrics_j, params), (module, grads_t, metrics_t, torch.cat(departed))


def test_v1_grad_step_matches_jax(v1_steps):
    """The grad step's metrics at the v2 step's tolerances, and every
    trainable parameter's gradient; the port's own ReLU branches differ
    from JAX's only at a few inputs within rounding of 0."""
    (grads_j, metrics_j, _), (module, grads_t, metrics_t, departed) = v1_steps
    assert departed.numel() <= 8 and bool((departed.abs() < 1e-5).all()), departed
    assert set(metrics_t) == set(metrics_j) and float(metrics_j["patch_16"]) > 0
    for k, want in metrics_j.items():
        assert float(metrics_t[k]) == pytest.approx(float(want), rel=METRIC_RTOL, abs=METRIC_ATOL), k
    want = v1_state_dict_from_jax_params(TINY_V1, jax.tree.map(np.asarray, grads_j))
    assert set(grads_t) == {n for n, p in module.named_parameters() if p.requires_grad}
    for name, g in grads_t.items():
        w = want[name]
        assert float(w.abs().max()) > 0, name
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL * w.abs().max().item(),
                                   msg=lambda m: f"{name}: {m}")


def test_v1_apply_step_matches_jax(v1_steps):
    """The rest of a MoGe-1 step: both packages' ``make_apply_step`` under
    v1.json's optimizer (its param groups, the SequentialLR schedule, the
    global-norm clip) and the EMA, fed the same gradients (JAX's, from
    ``v1_steps``), hold the updated parameters and EMA to the v2 step's
    ``STEP_TOL``. So a whole step's distance to JAX's comes from the
    gradients alone, whose last digits move the update only where a
    gradient is near Adam's eps; ``test_v1_grad_step_matches_jax`` bounds
    the gradients."""
    (grads_j, _, params), _ = v1_steps
    before = v1_state_dict_from_jax_params(TINY_V1, params)
    module = MoGeV1(**TINY_V1)
    module.load_state_dict(before, strict=True)
    tx_j = jutils.build_optimizer(params, V1["optimizer"], V1["lr_scheduler"])
    tx_t = tutils.build_optimizer(module, V1["optimizer"], V1["lr_scheduler"])
    state_j, ok_j = jax.jit(jstep.make_apply_step(tx_j))(jstep.init_train_state(params, tx_j), grads_j)
    grads = v1_state_dict_from_jax_params(TINY_V1, jax.tree.map(np.asarray, grads_j))
    trainable = [n for n, p in module.named_parameters() if p.requires_grad]
    state_t, ok_t = tstep.make_apply_step(tx_t)(tstep.init_train_state(module, tx_t),
                                                {n: grads[n] for n in trainable})
    assert bool(ok_j) and ok_t and state_t.step == int(state_j.step) == 1
    want = v1_state_dict_from_jax_params(TINY_V1, jax.tree.map(np.asarray, state_j.params))
    want_ema = v1_state_dict_from_jax_params(TINY_V1, jax.tree.map(np.asarray, state_j.ema_params))
    named = dict(module.named_parameters())
    moved = 0
    for name in trainable:
        moved += int(not torch.equal(named[name].detach(), before[name]))
        np.testing.assert_allclose(named[name].detach().numpy(), want[name].numpy(), rtol=0, atol=STEP_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(state_t.ema_params[name].numpy(), want_ema[name].numpy(), rtol=0,
                                   atol=STEP_TOL, err_msg=name)
    assert moved > 0  # the head's group (lr 1e-4) moved; the backbone's starts at lr 0 under the warm-up


@pytest.mark.parametrize("size", [84, 96])
def test_output_block_input_gradient_is_float64_exact(size):
    """MoGe-1's mask output block (3x3 conv, a residual block with
    GroupNorm(1) and GroupNorm(2), ReLU, 1x1 conv): the port's fp32 gradient
    of its input within 1e-5 of the largest of a float64 evaluation of the
    same block in plain torch."""
    import torch.nn.functional as F

    from moge_tpu_torch.models.v1 import HeadOutputBlock

    torch.manual_seed(size)
    block = HeadOutputBlock(18, 1, 1, 32, 1, 2, "group_norm")
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn_like(p) * (0.2 if p.dim() > 1 else 0.5))
    x = torch.randn(2, size, size, 18)
    ct = torch.randn(2, size, size, 1)
    x32 = x.clone().requires_grad_()
    (block(x32) * ct).sum().backward()

    S = {k: v.double() for k, v in block.state_dict().items()}

    def conv3(h, name):
        return F.conv2d(F.pad(h.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate"), S[f"{name}.weight"],
                        S[f"{name}.bias"]).permute(0, 2, 3, 1)

    def group_norm(h, groups, name):
        b, hh, ww, c = h.shape
        h5 = h.reshape(b, hh, ww, groups, c // groups)
        m = h5.mean((1, 2, 4), keepdim=True)
        v = (h5 - m).square().mean((1, 2, 4), keepdim=True)
        return ((h5 - m) / torch.sqrt(v + 1e-5)).reshape(b, hh, ww, c) * S[f"{name}.weight"] + S[f"{name}.bias"]

    x64 = x.double().requires_grad_()
    h = conv3(x64, "0")
    r = conv3(torch.relu(group_norm(h, 1, "1.layers.0")), "1.layers.2")
    r = conv3(torch.relu(group_norm(r, 2, "1.layers.3")), "1.layers.5") + h
    out = F.conv2d(torch.relu(r).permute(0, 3, 1, 2), S["3.weight"], S["3.bias"]).permute(0, 2, 3, 1)
    (out * ct.double()).sum().backward()
    ref = x64.grad
    assert ((x32.grad.double() - ref).abs().max() / ref.abs().max()).item() < 1e-5


@pytest.fixture(scope="module")
def v1_config(tmp_path_factory):
    """v1.json with the tiny MoGe-1, the cut loss tables, the synthetic
    datasets under v1's label types (synthetic, sfm, lidar) at 4-16k pixels
    and one low-resolution step."""
    root = tmp_path_factory.mktemp("train_v1")
    cfg = copy.deepcopy(V1)
    cfg["model"] = dict(TINY_V1)
    cfg["loss"] = _loss_config()
    datasets = write_train_dataset(root / "data", n_instances=3, hw=(96, 128))
    for ds, label in zip(datasets, ("synthetic", "sfm", "lidar")):
        ds["label_type"] = label
    cfg["data"] = {**cfg["data"], "datasets": datasets, "area_range": [4000, 16000]}
    cfg["low_resolution_training_steps"] = 1
    path = root / "train.json"
    path.write_text(json.dumps(cfg))
    return path


def _train(config, workspace, *extra):
    args = ["train", "--config", str(config), "--workspace", str(workspace), "--batch_size_forward", "2",
            "--log_every", "1", "--num_tokens_quantum", "4", "--device", "cpu", *extra]
    return cli.command().main(args, standalone_mode=False)


def test_train_v1_writes_a_moge1_checkpoint(v1_config, tmp_path):
    """Two steps of ``train`` on the v1 config: finite losses under v1's
    label types, and checkpoints (model.pt and the EMA's) in the v1 layout
    that ``models.v1.MoGeModel.from_pretrained`` loads and ``infer`` runs."""
    result = _train(v1_config, tmp_path, "--num_iterations", "2", "--save_every", "1")
    steps = [json.loads(x) for x in (tmp_path / "steps.jsonl").read_text().splitlines()]
    assert [s["step"] for s in steps] == [0, 1] and all(np.isfinite(s["total"]) for s in steps)
    assert {lt for s in steps for b in s["label_types"] for lt in b} <= {"synthetic", "sfm", "lidar", "invalid"}
    metrics = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert all(m["grads_ok"] == 1.0 and {"global", "mask", "total"} <= set(m) for m in metrics)
    assert isinstance(result["state"].module, MoGeV1) and result["state"].optimizer.count == 2
    for name in ("1", "1_ema"):
        ckpt = torch.load(tmp_path / "checkpoints" / name / "model.pt", weights_only=True)
        assert ckpt["model_config"] == TINY_V1
        assert all(k.startswith(("backbone.", "head.", "image_")) for k in ckpt["model"])
        model = MoGeModel.from_pretrained(tmp_path / "checkpoints" / name / "model.pt", device="cpu",
                                          dtype=torch.float32)
        out = model.infer(torch.rand(56, 70, 3), num_tokens=20)
        assert out["depth"].shape == (56, 70) and torch.isfinite(out["intrinsics"]).all()


def test_train_v1_grafts_the_backbone_checkpoint(v1_config, tmp_path):
    vit = DinoVisionTransformer(VIT_ARCHS["dinov2_vitt14"])
    init_params(vit, 1)
    torch.save(vit.state_dict(), tmp_path / "hub.pth")
    result = _train(v1_config, tmp_path / "ws", "--num_iterations", "1", "--backbone_checkpoint",
                    str(tmp_path / "hub.pth"))
    got = result["state"].module.backbone.state_dict()
    want = vit.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
