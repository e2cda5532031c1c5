"""The port's ``train`` command (moge_tpu_torch.scripts.train) on the CPU
with the tiny MoGe-2 and synthetic datasets (``write_train_dataset``):
the logs and checkpoints it writes, under the JAX command's file names and
keys; the full-state checkpoint round trip and the step after a resume, bit
for bit; two resumes from one checkpoint giving the same losses; gradient
accumulation against one step on the concatenated batch; the XLA-only flags
and parallel flags this run cannot honour, and a missing card, refused; the DINOv2 hub graft of
``--backbone_checkpoint``; and the learning rates after a resume against
the JAX package's schedule at the restored update count."""

import copy
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from moge_tpu.train import utils as jutils
from moge_tpu_torch.models.convert import load_dinov2_backbone
from moge_tpu_torch.models.dinov2 import VIT_ARCHS, DinoVisionTransformer
from moge_tpu_torch.models.io import (load_train_checkpoint, restore_train_state, save_train_checkpoint,
                                     snapshot_train_state, wait_for_checkpoints)
from moge_tpu_torch.models.modules import init_params
from moge_tpu_torch.models.v2 import MoGeModel, MoGeV2
from moge_tpu_torch.scripts import cli
from moge_tpu_torch.scripts.train import batch_to_device, train_iteration
from moge_tpu_torch.train import step as tstep
from moge_tpu_torch.train.dataloader import TrainDataLoaderPipeline
from moge_tpu_torch.train.utils import build_optimizer
from torch_tiny_config import TINY_CONFIG, write_train_dataset

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
V2 = json.loads((ROOT / "configs/train/v2.json").read_text())


def _loss_config():
    """v2.json's loss tables with the solves cut to 8/6/4/2 anchors a side
    and 4/16/64 patches per image, for images of 4-16k pixels."""
    loss = copy.deepcopy(V2["loss"])
    for table in loss.values():
        for name, res, patches in (("global", 8, None), ("patch_4", 6, 4), ("patch_16", 4, 16),
                                   ("patch_64", 2, 64)):
            if name in table:
                table[name]["params"]["align_resolution"] = res
                if patches:
                    table[name]["params"]["num_patches"] = patches
    return loss


@pytest.fixture(scope="module")
def train_config(tmp_path_factory):
    """v2.json with the tiny model (16-36 tokens), the cut loss tables, the
    synthetic datasets at 4-16k pixels and one low-resolution step."""
    root = tmp_path_factory.mktemp("train_cli")
    cfg = copy.deepcopy(V2)
    cfg["model"] = {**TINY_CONFIG, "num_tokens_range": [16, 36]}
    cfg["loss"] = _loss_config()
    cfg["data"] = {**cfg["data"], "datasets": write_train_dataset(root / "data", n_instances=3, hw=(96, 128)),
                   "area_range": [4000, 16000]}
    cfg["low_resolution_training_steps"] = 1
    path = root / "train.json"
    path.write_text(json.dumps(cfg))
    return path


def _train(config, workspace, *extra):
    """``cli train`` in-process on the CPU; returns the command's result."""
    args = ["train", "--config", str(config), "--workspace", str(workspace), "--batch_size_forward", "2",
            "--log_every", "1", "--num_tokens_quantum", "4", "--device", "cpu", *extra]
    return cli.command().main(args, standalone_mode=False)


@pytest.fixture(scope="module")
def first_run(train_config, tmp_path_factory):
    """Four steps, checkpoints at steps 2 and 3."""
    ws = tmp_path_factory.mktemp("ws")
    return ws, _train(train_config, ws, "--num_iterations", "4", "--save_every", "2")


def _read_lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_train_writes_logs_and_checkpoints(first_run):
    ws, result = first_run
    steps = _read_lines(ws / "steps.jsonl")
    assert [s["step"] for s in steps] == [0, 1, 2, 3] == [s["step"] for s in result["steps"]]
    assert all(set(s) == {"step", "num_tokens", "t", "total", "data_wait", "sizes", "label_types"} for s in steps)
    assert [s["num_tokens"] for s in steps[:2]] == [16, 16]  # the low-resolution steps
    assert all(16 <= s["num_tokens"] <= 36 and s["num_tokens"] % 4 == 0 for s in steps)
    assert all(np.isfinite(s["total"]) and s["data_wait"] >= 0 for s in steps)
    assert all(h % 32 == 0 and w % 32 == 0 for s in steps for h, w in s["sizes"])
    metrics = _read_lines(ws / "metrics.jsonl")
    assert [m["step"] for m in metrics] == [0, 1, 2, 3]
    assert all({"total", "grads_ok", "global", "mask", "monitoring.std"} <= set(m) for m in metrics)
    assert all(m["grads_ok"] == 1.0 for m in metrics)
    state = result["state"]
    assert state.step == 4 and state.optimizer.count == 4
    ckpts = ws / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == ["2", "2_ema", "3", "3_ema"]
    for name in ("2", "3"):
        assert sorted(p.name for p in (ckpts / name).iterdir()) == ["model.pt", "train_state.pt"]
        assert sorted(p.name for p in (ckpts / f"{name}_ema").iterdir()) == ["model.pt"]
    # the checkpoint's model.pt is a reference-format inference checkpoint
    for name in ("3", "3_ema"):
        model = MoGeModel.from_pretrained(ckpts / name / "model.pt", device="cpu", dtype=torch.float32)
        out = model.infer(torch.rand(56, 70, 3), num_tokens=20)
        assert out["depth"].shape == (56, 70)
    ema = torch.load(ckpts / "3_ema" / "model.pt", weights_only=True)["model"]
    for name, e in state.ema_params.items():
        assert torch.equal(ema[name], e)


def _fresh_state(config_path):
    cfg = json.loads(Path(config_path).read_text())
    module = MoGeV2(**cfg["model"])
    tx = build_optimizer(module, cfg["optimizer"], cfg["lr_scheduler"])
    return cfg, tstep.init_train_state(module, tx), torch.Generator().manual_seed(12345)


def _assert_same(a, b, where):
    for key in ("model", "ema"):
        assert a[key].keys() == b[key].keys()
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), f"{where}: {key} {k}"
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["count"] == ob["count"], where
    assert oa["adamw"]["state"].keys() == ob["adamw"]["state"].keys()
    for i, s in oa["adamw"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, ob["adamw"]["state"][i][k]), f"{where}: adamw {i} {k}"
    assert a["step"] == b["step"] and torch.equal(a["gen"], b["gen"]), where


def _fixed_batch(config_path, seed=3):
    cfg = json.loads(Path(config_path).read_text())
    with TrainDataLoaderPipeline(cfg["data"], 2, random.Random(seed), 32, 1, 1, 1) as pipe:
        return batch_to_device(pipe.get(), sorted(cfg["loss"]), "cpu")


def test_round_trip_and_resumed_step_are_bit_exact(first_run, train_config):
    """The checkpoint of the last step loads into a fresh state equal to the
    live one; the next step from each, on one batch, is equal too: params,
    AdamW moments, EMA, update count, learning rates and generator."""
    ws, result = first_run
    live, live_gen = result["state"], result["gen"]
    cfg, loaded, gen = _fresh_state(train_config)
    load_train_checkpoint(ws / "checkpoints" / "3", loaded, gen)
    _assert_same(snapshot_train_state(loaded, gen), snapshot_train_state(live, live_gen), "round trip")
    assert loaded.optimizer.lrs() == live.optimizer.lrs()

    batch = _fixed_batch(train_config)
    live_copy = copy.deepcopy(live)  # the fixture's state stays as the run left it
    live_copy_gen = torch.Generator().manual_seed(0)
    live_copy_gen.set_state(live_gen.get_state())
    after = []
    for state, g in ((live_copy, live_copy_gen), (loaded, gen)):
        step = tstep.make_train_step(state.module, state.optimizer, cfg["loss"], sorted(cfg["loss"]), 20)
        state, metrics = step(state, batch, g)
        assert float(metrics["grads_ok"]) == 1.0
        after.append((snapshot_train_state(state, g), float(metrics["total"]), state.optimizer.lrs()))
    _assert_same(after[0][0], after[1][0], "resumed step")
    assert after[0][1:] == after[1][1:]


def test_restoring_one_snapshot_twice_gives_one_step(first_run, train_config):
    """A state restored from a snapshot shares no tensor with it (AdamW
    would update its step counts in place): two restores, two equal steps."""
    ws, _ = first_run
    cfg, state, gen = _fresh_state(train_config)
    load_train_checkpoint(ws / "checkpoints" / "2", state, gen)
    snap = snapshot_train_state(state, gen)
    batch = _fixed_batch(train_config)
    after = []
    for _ in range(2):
        restore_train_state(state, gen, snap)
        step = tstep.make_train_step(state.module, state.optimizer, cfg["loss"], sorted(cfg["loss"]), 20)
        step(state, batch, gen)
        after.append(snapshot_train_state(state, gen))
    _assert_same(after[0], after[1], "two restores")


def test_two_resumes_give_identical_losses(first_run, train_config, tmp_path):
    ws, _ = first_run
    losses = []
    for name in ("a", "b"):
        result = _train(train_config, tmp_path / name, "--num_iterations", "5", "--save_every", "100",
                        "--checkpoint", str(ws / "checkpoints" / "2"))
        lines = _read_lines(tmp_path / name / "steps.jsonl")
        assert [s["step"] for s in lines] == [3, 4] and result["state"].optimizer.count == 5
        losses.append([(s["total"], s["num_tokens"], s["sizes"]) for s in lines])
    assert losses[0] == losses[1]


def test_lr_after_resume_equals_jax_schedule(first_run, train_config):
    ws, _ = first_run
    cfg, state, gen = _fresh_state(train_config)
    load_train_checkpoint(ws / "checkpoints" / "2", state, gen)
    tx = state.optimizer
    assert state.step == 3 and tx.count == 3
    want = [spec["lr"] * float(jutils.build_lr_schedule(cfg["lr_scheduler"], gi)(jnp.asarray(tx.count)))
            for gi, spec in enumerate(cfg["optimizer"]["params"])]
    assert tx.lrs() == pytest.approx(want, rel=1e-6)
    assert [g["lr"] for g in tx.adamw.param_groups] == pytest.approx(
        [spec["lr"] * float(jutils.build_lr_schedule(cfg["lr_scheduler"], gi)(jnp.asarray(tx.count - 1)))
         for gi, spec in enumerate(cfg["optimizer"]["params"])], rel=1e-6)


def test_params_only_checkpoint_resumes_with_a_warning(first_run, train_config):
    """An ``_ema`` directory holds only model.pt: the parameters load, the
    optimizer and the EMA start afresh."""
    ws, _ = first_run
    cfg, state, gen = _fresh_state(train_config)
    with pytest.warns(UserWarning, match="params-only"):
        load_train_checkpoint(ws / "checkpoints" / "3_ema", state, gen)
    ema = torch.load(ws / "checkpoints" / "3_ema" / "model.pt", weights_only=True)["model"]
    assert all(torch.equal(p, ema[n]) for n, p in state.module.state_dict().items())
    assert state.optimizer.count == 0 and state.step == 0


def test_a_failed_checkpoint_write_is_raised(train_config, tmp_path):
    """The writer thread's error reaches the training thread at the join."""
    cfg, state, gen = _fresh_state(train_config)
    (tmp_path / "a_file").write_text("")
    save_train_checkpoint(tmp_path / "a_file" / "3", cfg["model"], state, gen)
    with pytest.raises(RuntimeError, match="checkpoint write to .* failed"):
        wait_for_checkpoints()
    wait_for_checkpoints()  # nothing left to join


_LOSS_NO_DRAWS = {"invalid": {}, "A": {
    "global": {"function": "affine_invariant_global_loss", "weight": 1.0, "params": {"align_resolution": 12}},
    "normal": {"function": "edge_loss", "weight": 1.0},
    "mask": {"function": "mask_bce_loss", "weight": 0.1}}}


def test_accumulation_equals_the_concatenated_batch(train_config):
    """``train_iteration`` over two micro-batches hands the update the mean
    of their gradients: the gradient of one step on the concatenated batch,
    to test_accumulated_half_batches_equal_the_full_batch's tolerance."""
    cfg = json.loads(Path(train_config).read_text())
    module = MoGeV2(**cfg["model"]).init_random(seed=0)
    tx = build_optimizer(module, cfg["optimizer"], cfg["lr_scheduler"])
    state = tstep.init_train_state(module, tx)
    batch = _fixed_batch(train_config, seed=4)
    batch["label_type_idx"] = torch.ones_like(batch["label_type_idx"])  # "A" in ["A", "invalid"]
    grad_step = tstep.make_grad_step(module, _LOSS_NO_DRAWS, ["A", "invalid"], 16, torch.float32)
    full, full_metrics = grad_step(batch, torch.Generator())
    halves = iter([{k: v[i:i + 1] for k, v in batch.items()} for i in range(2)])
    handed = {}

    def apply_step(st, grads):
        handed.update(grads)
        return tstep.make_apply_step(tx)(st, grads)

    state, record, batches = train_iteration(state, grad_step, apply_step, lambda: next(halves), 2,
                                             torch.Generator())
    assert len(batches) == 2 and state.step == 1 and tx.count == 1 and record["grads_ok"] == 1.0
    for name, g in full.items():
        torch.testing.assert_close(handed[name], g, rtol=1e-4, atol=1e-6 * g.abs().max().item() + 1e-12)
    assert record["total"] == pytest.approx(float(full_metrics["total"]), rel=1e-5)


def test_train_accumulates_two_micro_batches(train_config, tmp_path):
    result = _train(train_config, tmp_path, "--num_iterations", "2", "--save_every", "100",
                    "--gradient_accumulation_steps", "2")
    lines = _read_lines(tmp_path / "steps.jsonl")
    assert result["state"].optimizer.count == 2 and [len(s["sizes"]) for s in lines] == [2, 2]
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == ["1", "1_ema"]


def test_vis_every_writes_the_pictures(train_config, tmp_path):
    _train(train_config, tmp_path, "--num_iterations", "1", "--vis_every", "1")
    assert sorted(p.name for p in (tmp_path / "vis" / "0").iterdir()) == \
        [f"{i}_{kind}" for i in range(2) for kind in ("gt.png", "image.jpg", "pred.png")]


@pytest.mark.parametrize("flag", [["--fsdp", "2"], ["--multihost"], ["--coordinator", "h:1"],
                                  ["--num_processes", "2"], ["--process_id", "1"], ["--no_flash"],
                                  ["--scan_blocks"], ["--split_loss_programs", "on"]],
                         ids=lambda f: f[0].lstrip("-"))
def test_jax_only_flags_are_refused(train_config, tmp_path, flag):
    """The XLA-only switches refuse any value but their default; the
    parallel flags, ported, refuse what this one-process CPU run cannot
    honour: ``--fsdp 2`` (one process), ``--multihost`` without its job
    (rendezvous, world size, rank), and the job's flags without
    ``--multihost``. Nothing is written."""
    from click.testing import CliRunner

    result = CliRunner().invoke(cli.command(), ["train", "--config", str(train_config), "--workspace",
                                                str(tmp_path), "--device", "cpu", *flag])
    assert result.exit_code == 2 and "Error" in result.output, result.output
    assert not (tmp_path / "steps.jsonl").exists()


def test_train_refuses_a_missing_card(train_config, tmp_path):
    from click.testing import CliRunner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    result = CliRunner().invoke(cli.command(), ["train", "--config", str(train_config), "--workspace",
                                                str(tmp_path), "--device", "cuda"])
    assert result.exit_code == 2 and "no CUDA device" in result.output, result.output


def _hub_file(path, arch, wrapper, seed=1):
    vit = DinoVisionTransformer(VIT_ARCHS[arch])
    init_params(vit, seed)
    sd = vit.state_dict()
    torch.save({wrapper: sd} if wrapper else sd, path)
    return sd


@pytest.mark.parametrize("wrapper", [None, "teacher", "model"])
def test_backbone_checkpoint_is_grafted(train_config, tmp_path, wrapper):
    sd = _hub_file(tmp_path / "hub.pth", "dinov2_vitt14", wrapper)
    if wrapper is None:  # through the command: one step, at the backbone's warm-up lr of 0
        result = _train(train_config, tmp_path / "ws", "--num_iterations", "1",
                        "--backbone_checkpoint", str(tmp_path / "hub.pth"))
        got = result["state"].module.encoder.backbone.state_dict()
    else:
        module = MoGeV2(**json.loads(Path(train_config).read_text())["model"]).init_random(seed=0)
        load_dinov2_backbone(module.encoder.backbone, torch.load(tmp_path / "hub.pth", weights_only=True))
        got = module.encoder.backbone.state_dict()
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)


def test_mismatched_backbone_checkpoint_is_rejected(train_config, tmp_path):
    _hub_file(tmp_path / "hub.pth", "dinov2_vits14", None)
    with pytest.raises(ValueError, match="does not match the configured architecture"):
        _train(train_config, tmp_path / "ws", "--num_iterations", "1", "--backbone_checkpoint",
               str(tmp_path / "hub.pth"))
