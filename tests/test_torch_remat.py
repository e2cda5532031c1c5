"""Activation checkpointing (``remat``) in the port's models on the CPU, at
the tiny configs: the grad step with ``remat`` equal to the one without,
bit for bit, for MoGe-2 and MoGe-1 in fp32 and bf16; the rematerialized
MoGe-2's raw forward and parameter gradients against the JAX package's
``MoGeV2(remat=True)`` under ``jax.vjp``; no checkpoint entered with grad
mode off, and the inference outputs unchanged; the batchability rule
against JAX's; and two gloo ranks with FSDP and ``remat`` against one
process without it."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

import jax
import jax.numpy as jnp

from moge_tpu.models import multihead as jax_multihead
from moge_tpu.models.v2 import MoGeV2 as JaxMoGeV2
from moge_tpu_torch.models.multihead import heads_batchable
from moge_tpu_torch.models.v1 import MoGeV1
from moge_tpu_torch.models.v2 import MoGeV2
from moge_tpu_torch.parallel.distributed import spawn
from moge_tpu_torch.train import step as tstep
from test_torch_grads import GRAD_TOL
from test_torch_parallel import GRAD_ATOL, GRAD_RTOL, LR_SCALE
from test_torch_train import _LABEL_TYPES, _LOSS_CONFIG, _batch
from test_torch_train_v1 import TINY_V1, _batch as _v1_batch, _loss_config as _v1_loss_config
from torch_tiny_config import TINY_CONFIG, state_dict_from_jax_params, whole_train_state

torch.set_num_threads(1)

V2 = json.loads((Path(__file__).resolve().parent.parent / "configs/train/v2.json").read_text())
HEADS = ("points_head", "normal_head", "mask_head")
FSDP_STEPS = 2
# test_fsdp_step_equals_the_single_process_step's parameter tolerance: a
# twentieth of the larger learning rate per update
STEP_TOL = 5e-6 * LR_SCALE * FSDP_STEPS


def _checkpoints(tiny):
    """The checkpoints one training forward of ``tiny`` enters: each ViT
    block, and each residual block and resampler of the neck and heads."""
    from moge_tpu_torch.models.dinov2 import VIT_ARCHS

    stacks = [tiny["neck"], *(tiny[h] for h in HEADS)]
    return (VIT_ARCHS[tiny["encoder"]["backbone"]].depth
            + sum(sum(s["num_res_blocks"]) + len(s["dim_res_blocks"]) - 1 for s in stacks))


@pytest.fixture
def entered(monkeypatch):
    """Every call of torch.utils.checkpoint.checkpoint, by its keyword arguments."""
    calls = []
    checkpoint = torch.utils.checkpoint.checkpoint

    def spy(fn, *args, **kwargs):
        calls.append(kwargs)
        return checkpoint(fn, *args, **kwargs)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    return calls


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grad_step(version, remat, dtype):
    """(loss, gradients by name) of one grad step of the tiny MoGe-2 (the
    whole-step test's loss table, no draws) or MoGe-1 (v1.json's tables,
    cut; its local losses draw from a generator seeded alike each call)."""
    if version == "v2":
        module = MoGeV2(**TINY_CONFIG, remat=remat).init_random(seed=0)
        loss, label_types, batch, num_tokens = _LOSS_CONFIG, _LABEL_TYPES, _batch(), 16
    else:
        module = MoGeV1(**TINY_V1, remat=remat).init_random(seed=0)
        loss = _v1_loss_config()
        label_types = sorted(loss)
        batch, num_tokens = _v1_batch(label_types), 36
    step = tstep.make_grad_step(module, loss, label_types, num_tokens, dtype)
    grads, metrics = step(_tensors(batch), torch.Generator().manual_seed(7))
    return metrics["total"], grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("version", ["v2", "v1"])
def test_grad_step_with_remat_equals_the_step_without(version, dtype, entered):
    """Tolerance: none (``torch.equal``). The checkpoints rebuild what the
    backward reads by running the same forward on the same inputs, and the
    autograd graph is the one without them, so the loss and every gradient
    are the same bits. A reentrant checkpoint fails here twice over: by its
    keyword, and by its gradients, which reach every parameter but are
    summed in another order, so the backbone's differ in their last bits."""
    plain = _grad_step(version, False, dtype)
    assert not entered
    remat = _grad_step(version, True, dtype)
    assert entered and all(kw.get("use_reentrant") is False for kw in entered)
    assert torch.equal(remat[0], plain[0])
    assert remat[1].keys() == plain[1].keys()
    differ = [n for n, g in plain[1].items() if not torch.equal(remat[1][n], g)]
    assert not differ, differ[:5]


def test_raw_forward_and_gradients_match_jax_remat():
    """The rematerialized raw forward (``MoGeV2.decode``: the points,
    normal and mask maps at decoder resolution and the metric scale) and
    the parameter gradients of the sum of its outputs times a seeded
    cotangent, against ``jax.vjp`` of JAX's ``MoGeV2(remat=True).decode``
    (its plain path) with the same weights, fp32, both within
    test_torch_grads's GRAD_TOL relative to each tensor's largest element."""
    module_j = JaxMoGeV2(**TINY_CONFIG, dtype=jnp.float32, remat=True)
    params = jax.jit(module_j.init, static_argnums=(2,))(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)),
                                                          16)["params"]
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    base_h, base_w = 4, 5
    image_14 = rng.uniform(0, 1, (2, 14 * base_h, 14 * base_w, 3)).astype(np.float32)
    aspect = base_w / base_h
    out_j, vjp = jax.vjp(lambda p: module_j.apply({"params": p}, jnp.asarray(image_14), base_h, base_w, aspect,
                                                  method="decode"), params)
    cot = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in sorted(out_j.items())}
    (grads_j,) = vjp({k: jnp.asarray(v) for k, v in cot.items()})
    want = state_dict_from_jax_params(TINY_CONFIG, jax.tree.map(np.asarray, grads_j))

    module = MoGeV2(**TINY_CONFIG, remat=True)
    module.load_state_dict(state_dict_from_jax_params(TINY_CONFIG, params), strict=True)
    out = module.decode(torch.from_numpy(image_14), base_h, base_w, aspect, torch.float32)
    assert set(out) == set(out_j)
    for k, v in out_j.items():
        w = np.asarray(v)
        np.testing.assert_allclose(out[k].detach().numpy(), w, rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=k)
    named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
    got = torch.autograd.grad(sum((out[k] * torch.from_numpy(c)).sum() for k, c in cot.items()),
                              [p for _, p in named])
    for (name, _), g in zip(named, got):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_no_checkpoint_without_grad_mode(mode, entered):
    """Under ``torch.no_grad()`` or ``torch.inference_mode()`` the
    rematerialized model enters no checkpoint and its outputs equal the
    plain model's (``torch.equal``), in fp32 and bf16; with grad mode on it
    enters one per ViT block and per residual block and resampler."""
    plain = MoGeV2(**TINY_CONFIG).init_random(seed=0)
    remat = MoGeV2(**TINY_CONFIG, remat=True).init_random(seed=0)
    image = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 56, 70, 3)).astype(np.float32))
    context = torch.no_grad if mode == "no_grad" else torch.inference_mode
    for dtype in (torch.float32, torch.bfloat16):
        with context():
            want, got = plain(image, 20, dtype), remat(image, 20, dtype)
        assert not entered
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    remat(image, 20, torch.float32)
    assert len(entered) == _checkpoints(TINY_CONFIG) == 32


def test_remat_turns_batched_heads_off(monkeypatch):
    """``heads_batchable(cfgs, remat)`` beside JAX's (which reads
    MOGE_BATCHED_HEADS itself): batchable heads are batched without remat
    and not with it, and a module asked for both runs them one by one."""
    monkeypatch.setenv("MOGE_BATCHED_HEADS", "1")
    cfgs = [TINY_CONFIG[h] for h in HEADS]
    for remat in (False, True):
        assert heads_batchable(cfgs, remat) == jax_multihead.heads_batchable(cfgs, remat) == (not remat)
    assert heads_batchable(cfgs)
    assert MoGeV2(**TINY_CONFIG, batched_heads=True).batched_heads
    assert not MoGeV2(**TINY_CONFIG, batched_heads=True, remat=True).batched_heads


def _optimizer():
    """v2.json's optimizer with its learning rates scaled by LR_SCALE (test_torch_parallel's config)."""
    cfg = json.loads(json.dumps(V2["optimizer"]))
    for group in cfg["params"]:
        group["lr"] *= LR_SCALE
    return cfg


def _steps(module, batch, ranks=None):
    """FSDP_STEPS optimizer steps of ``module`` on ``batch`` (this rank's
    share under ``ranks``): the whole train state and the logged records."""
    from moge_tpu_torch.scripts.train import train_iteration
    from moge_tpu_torch.train.utils import build_optimizer

    tx = build_optimizer(module, _optimizer(), V2["lr_scheduler"])
    state, gen = tstep.init_train_state(module, tx), torch.Generator()
    grad_step = tstep.make_grad_step(module, _LOSS_CONFIG, _LABEL_TYPES, 16, torch.float32, ranks)
    apply_step = tstep.make_apply_step(tx)
    records = []
    for _ in range(FSDP_STEPS):
        state, record, _ = train_iteration(state, grad_step, apply_step, lambda: batch, 1, gen, ranks)
        records.append(record)
    return whole_train_state(state, gen), records


def _fsdp_remat_rank(rank, world, tmp):
    """One rank of test_fsdp_with_remat_equals_one_process_without: the
    tiny MoGe-2 with ``remat``, sharded over both ranks, its share of the
    batch; rank 0 writes the gathered state, the records and the
    checkpoints it entered."""
    from moge_tpu_torch.parallel.distributed import Parallel
    from moge_tpu_torch.parallel.mesh import shard_batch, shard_params

    torch.set_num_threads(1)
    entered = []
    checkpoint = torch.utils.checkpoint.checkpoint
    torch.utils.checkpoint.checkpoint = lambda fn, *a, **kw: entered.append(kw) or checkpoint(fn, *a, **kw)
    ranks = Parallel.join(2, torch.device("cpu"))
    module = MoGeV2(**TINY_CONFIG, remat=True).init_random(seed=0)
    shard_params(module, ranks.mesh)
    whole, records = _steps(module, shard_batch(_tensors(_batch()), rank, world), ranks)
    if rank == 0:
        torch.save({"state": whole, "records": records, "entered": entered, "shard": ranks.shard},
                   tmp / "rank0.pt")


def test_fsdp_with_remat_equals_one_process_without(tmp_path):
    """Two gloo ranks, fsdp 2, the module built with ``remat`` (each rank
    one instance of the batch of 2, non-reentrant checkpoints inside the
    FSDP2 units) against one process without ``remat`` on the whole batch:
    FSDP_STEPS steps, at test_fsdp_step_equals_the_single_process_step's
    tolerances (AdamW's moments GRAD_RTOL and GRAD_ATOL of the largest,
    the parameters and the EMA STEP_TOL, the step counts equal, the logged
    losses 1e-5 relative)."""
    want, want_records = _steps(MoGeV2(**TINY_CONFIG).init_random(seed=0), _tensors(_batch()))
    spawn(_fsdp_remat_rank, 2, "cpu", tmp_path / "rendezvous", (tmp_path,))
    got = torch.load(tmp_path / "rank0.pt", weights_only=False)
    assert got["shard"] and len(got["entered"]) == FSDP_STEPS * _checkpoints(TINY_CONFIG)
    assert all(kw.get("use_reentrant") is False for kw in got["entered"])
    tensors = got["state"]["tensors"]
    assert tensors.keys() == want["tensors"].keys()
    for k, v in want["tensors"].items():
        if ".exp_avg" in k:
            torch.testing.assert_close(tensors[k], v, rtol=GRAD_RTOL, atol=GRAD_ATOL * v.abs().max().item() + 1e-12,
                                       msg=lambda m: f"{k}: {m}")
        elif ".step" in k:
            assert torch.equal(tensors[k], v), k
        else:
            torch.testing.assert_close(tensors[k], v, rtol=0, atol=STEP_TOL, msg=lambda m: f"{k}: {m}")
    assert [r["grads_ok"] for r in got["records"]] == [1.0] * FSDP_STEPS
    assert [r["total"] for r in got["records"]] == pytest.approx([r["total"] for r in want_records], rel=1e-5)
