"""The port's parallel training (moge_tpu_torch.parallel, ``train --fsdp /
--multihost``) on the CPU: two gloo processes, each one rank of a ``train``
run in its own process (``torch_tiny_config.train_rank_main``), the tiny
MoGe-2 on the synthetic datasets, a loss table with no random draws
(global, normal and mask losses) and fp32 compute, against one process on
the same global batch. The mesh layout rule against the JAX package's
test, the ranks' shares of the loader's batch, data parallelism (dp 2) and
FSDP (fsdp 2) step for step, the ranks' states, the FSDP checkpoint's bytes
and its resume, the default run over local ranks, and the derived-weight
cache of a sharded module."""

import copy
import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from moge_tpu_torch.parallel.distributed import layout_multihost_devices, local_share, spawn
from moge_tpu_torch.parallel.mesh import shard_batch
from moge_tpu_torch.scripts import cli, train
from moge_tpu_torch.train.dataloader import TrainDataLoaderPipeline
from torch_tiny_config import TINY_CONFIG, whole_train_state, write_train_dataset

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
V2 = json.loads((ROOT / "configs/train/v2.json").read_text())
STEPS = 2
TIMEOUT = 240  # seconds for one two-process run (each takes ~10 s here)
# v2.json's learning rates over 100: a later step's gradient is taken at
# parameters one update apart, and an update's size follows the lr
LR_SCALE = 1e-2
# tests/test_torch_train.py's tolerances: a twentieth of the larger lr per
# update for the parameters (test_train_step_matches_jax's STEP_TOL at its
# lr 1e-4), the logged losses as the whole step's metrics, and for the
# gradients (AdamW's moments) the accumulated half batches' rtol with an
# atol of 1e-5 of the largest: a batch of 2 in one process against two of 1
# sums in another order, which here moved the moments by up to 1.2e-6 of
# the largest after one step and 2.4e-6 after two
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
STEP_TOL = 5e-6 * LR_SCALE * STEPS
LOSS_RTOL = 1e-5


class _StubDev:
    def __init__(self, proc, idx):
        self.process_index = proc
        self.id = idx


def test_layout_fsdp_within_host():
    """fsdp groups never straddle hosts (tests/test_multihost.py's case)."""
    devs = [_StubDev(p, i) for p in range(2) for i in range(4)]
    grid = layout_multihost_devices(devs, fsdp=4)
    assert grid.shape == (2, 4)
    for row in grid:
        assert len({d.process_index for d in row}) == 1
    assert [row[0].process_index for row in grid] == [0, 1]
    grid2 = layout_multihost_devices(devs, fsdp=2)
    assert grid2.shape == (4, 2)
    for row in grid2:
        assert len({d.process_index for d in row}) == 1


def test_layout_rejects_straddling_fsdp():
    devs = [_StubDev(p, i) for p in range(2) for i in range(3)]
    with pytest.raises(ValueError, match="divisible by fsdp"):
        layout_multihost_devices(devs, fsdp=2)


def test_single_process_parallel_is_the_identity():
    """Without a mesh ``Parallel`` runs no collective: the gradients, the
    metrics and a gather come back as they went; rank 0's loss seed is the
    run's seed; a host:port rendezvous becomes a TCP URL, a URL stays."""
    from moge_tpu_torch.parallel.distributed import Parallel, init_method, loss_seed

    ranks = Parallel()
    grads = {"w": torch.ones(3)}
    assert ranks.mean_grads(grads) is grads and ranks.mean_metrics({"a": 1.0}) == {"a": 1.0}
    assert ranks.gather("x") == ["x"] and (ranks.dp, ranks.fsdp, ranks.is_main) == (1, 1, True)
    assert loss_seed(7, 0) == 7 and len({loss_seed(7, r) for r in range(4)}) == 4
    assert init_method("h:1") == "tcp://h:1" and init_method("file:///x") == "file:///x"


def test_initialize_distributed_needs_the_whole_job():
    from moge_tpu_torch.parallel.distributed import initialize_distributed

    with pytest.raises(ValueError, match="needs num_processes, process_id"):
        initialize_distributed("h:1", None, None, "gloo")
    with pytest.raises(ValueError, match="not a rank of 2"):
        initialize_distributed("h:1", 2, 2, "gloo")


@pytest.mark.parametrize("args, message", [
    (["--multihost", "--coordinator_address", "h:1"], "--multihost needs --num_processes, --process_id"),
    (["--coordinator_address", "h:1"], "--coordinator_address describe a --multihost job"),
    (["--fsdp", "0"], "--fsdp 0: must be at least 1"),
], ids=["multihost_without_job", "coordinator_address_alone", "fsdp_0"])
def test_parallel_flags_are_checked(config, tmp_path, args, message):
    """``--coordinator_address`` is the JAX command's ``--coordinator``; a
    job the command cannot start is refused before anything is written."""
    from click.testing import CliRunner

    result = CliRunner().invoke(cli.command(), ["train", "--config", str(config), "--workspace", str(tmp_path),
                                                "--device", "cpu", *args])
    assert result.exit_code == 2 and message in result.output, result.output
    assert not (tmp_path / "steps.jsonl").exists()


def test_local_share_rejects_an_uneven_batch():
    assert local_share(6, 1, 3) == slice(2, 4)
    with pytest.raises(ValueError, match="not divisible by 4 processes"):
        local_share(6, 0, 4)


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    """v2.json with the tiny model (16-36 tokens), the synthetic datasets at
    4-16k pixels, one low-resolution step and, for every label type, the
    global (8 anchors a side), normal and mask losses: no random draw; the
    learning rates scaled by LR_SCALE."""
    root = tmp_path_factory.mktemp("parallel")
    cfg = copy.deepcopy(V2)
    cfg["model"] = {**TINY_CONFIG, "num_tokens_range": [16, 36]}
    table = {"global": {"function": "affine_invariant_global_loss", "weight": 1.0, "params": {"align_resolution": 8}},
             "normal": {"function": "normal_loss", "weight": 1.0},
             "mask": {"function": "mask_bce_loss", "weight": 0.1}}
    cfg["loss"] = {"invalid": {}, "A": table, "B": table, "C": table}
    cfg["data"] = {**cfg["data"], "datasets": write_train_dataset(root / "data", n_instances=3, hw=(96, 128)),
                   "area_range": [4000, 16000]}
    cfg["low_resolution_training_steps"] = 1
    for group in cfg["optimizer"]["params"]:
        group["lr"] *= LR_SCALE
    path = root / "train.json"
    path.write_text(json.dumps(cfg))
    return path


def test_rank_shares_are_the_single_process_batch(config):
    """Each rank draws the global batch and loads its share: the two ranks'
    batches, in rank order, are the single-process batch instance for
    instance, three batches running, and each is ``shard_batch``'s cut of
    it."""
    cfg = json.loads(config.read_text())
    pipes = [TrainDataLoaderPipeline(cfg["data"], 4, random.Random(5), 32, 1, 1, 1, rank=r, world=w)
             for r, w in ((0, 1), (0, 2), (1, 2))]
    for p in pipes:
        p.start()
    try:
        for _ in range(3):
            whole, first, second = (p.get() for p in pipes)
            for k in ("image", "depth", "depth_mask_fin", "depth_mask_inf", "normal", "normal_mask", "intrinsics",
                      "is_metric"):
                assert first[k].shape[0] == 2 and np.array_equal(np.concatenate([first[k], second[k]]), whole[k]), k
            assert first["label_type"] + second["label_type"] == whole["label_type"]
            assert first["info"] + second["info"] == whole["info"]
            for rank, share in enumerate((first, second)):  # mesh.shard_batch cuts the whole batch alike
                cut = shard_batch(whole, rank, 2)
                assert cut.keys() == share.keys()
                assert all(np.array_equal(cut[k], share[k]) if isinstance(share[k], np.ndarray) else cut[k] == share[k]
                           for k in share)
    finally:
        for p in pipes:
            p.stop()
    with pytest.raises(ValueError, match="not divisible"):
        TrainDataLoaderPipeline(cfg["data"], 3, random.Random(5), 32, rank=0, world=2)


def _args(config, workspace, *extra):
    return ["--config", str(config), "--workspace", str(workspace), "--batch_size_forward", "2", "--log_every", "1",
            "--num_tokens_quantum", "4", "--save_every", "1", *extra]


def _two_ranks(tmp, config, workspace, *extra):
    """One ``train`` run of two gloo ranks, each in its own process; each
    rank's {'state': whole_train_state, 'steps'} and rank 0's output."""
    tmp.mkdir(parents=True, exist_ok=True)
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'tests')!r}]; "
            "import torch_tiny_config; torch_tiny_config.train_rank_main()")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp / f"rank{r}.pt"), str(r), "2",
                               f"file://{tmp / 'rendezvous'}", "float32", *_args(config, workspace, *extra)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)], outs[0]


@pytest.fixture(scope="module")
def single(config, tmp_path_factory, monkeypatch_module):
    """One process, the same global batch of 2: STEPS steps."""
    monkeypatch_module.setattr(train, "COMPUTE_DTYPE", torch.float32)
    ws = tmp_path_factory.mktemp("single")
    result = cli.command().main(["train", *_args(config, ws, "--num_iterations", str(STEPS), "--device", "cpu")],
                                standalone_mode=False)
    return ws, result, whole_train_state(result["state"], result["gen"])


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module")
def dp(config, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    return tmp, *_two_ranks(tmp, config, tmp / "ws", "--num_iterations", str(STEPS))


@pytest.fixture(scope="module")
def fsdp(config, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    return tmp, *_two_ranks(tmp, config, tmp / "ws", "--num_iterations", str(STEPS), "--fsdp", "2")


def _assert_identical(a, b, where, same_gen=True):
    """Every tensor and scalar equal; ``same_gen`` False: ranks, whose loss
    generators are seeded apart."""
    keys = [k for k in a["scalars"] if same_gen or k != "gen"]
    assert [a["scalars"][k] for k in keys] == [b["scalars"][k] for k in keys], where
    assert same_gen or a["scalars"]["gen"] != b["scalars"]["gen"], where
    assert a["tensors"].keys() == b["tensors"].keys(), where
    bad = [k for k, v in a["tensors"].items() if not torch.equal(v, b["tensors"][k])]
    assert not bad, f"{where}: {len(bad)} tensors differ, e.g. {bad[:3]}"


def _assert_close_to_single(got, single):
    """A multi-process run's state against the single process's."""
    _, result, want = single
    assert got["state"]["tensors"].keys() == want["tensors"].keys()
    for k, v in want["tensors"].items():
        g = got["state"]["tensors"][k]
        if ".exp_avg" in k:
            torch.testing.assert_close(g, v, rtol=GRAD_RTOL, atol=GRAD_ATOL * v.abs().max().item() + 1e-12,
                                       msg=lambda m: f"{k}: {m}")
        elif ".step" in k:
            assert torch.equal(g, v), k
        else:
            torch.testing.assert_close(g, v, rtol=0, atol=STEP_TOL, msg=lambda m: f"{k}: {m}")
    s_got, s_want = got["state"]["scalars"], want["scalars"]
    assert s_got == s_want  # rank 0's loss generator is seeded as the single process's
    assert [s["total"] for s in got["steps"]] == pytest.approx([s["total"] for s in result["steps"]], rel=LOSS_RTOL)
    for key in ("num_tokens", "sizes", "label_types"):
        assert [s[key] for s in got["steps"]] == [s[key] for s in result["steps"]], key


def test_dp_step_equals_the_single_process_step(dp, single):
    """dp 2: every tensor of the train state bit-identical on both ranks,
    and STEPS steps of the global batch as one process takes them."""
    _, ranks, out = dp
    assert "mesh: dp=2 x fsdp=1" in out, out
    _assert_identical(ranks[0]["state"], ranks[1]["state"], "dp ranks", same_gen=False)
    _assert_close_to_single(ranks[0], single)


def test_fsdp_step_equals_the_single_process_step(fsdp, single):
    """fsdp 2: the gathered state is the same on both ranks and follows
    the single process's, step for step."""
    _, ranks, out = fsdp
    assert "mesh: dp=1 x fsdp=2" in out, out
    _assert_identical(ranks[0]["state"], ranks[1]["state"], "fsdp ranks", same_gen=False)
    _assert_close_to_single(ranks[0], single)


def test_fsdp_checkpoint_has_the_unsharded_layout_and_bytes(fsdp, config, tmp_path):
    """The FSDP run's last checkpoint, loaded into an unsharded state and
    saved again by one process: model.pt and the EMA's byte for byte, and
    train_state.pt the same apart from the per-rank generator list."""
    from moge_tpu_torch.models.io import load_train_checkpoint, save_train_checkpoint, wait_for_checkpoints
    from moge_tpu_torch.models.v2 import MoGeModel, MoGeV2
    from moge_tpu_torch.train.step import init_train_state
    from moge_tpu_torch.train.utils import build_optimizer

    tmp, ranks, _ = fsdp
    ckpt = tmp / "ws" / "checkpoints" / str(STEPS - 1)
    cfg = json.loads(config.read_text())
    module = MoGeV2(**cfg["model"])
    state = init_train_state(module, build_optimizer(module, cfg["optimizer"], cfg["lr_scheduler"]))
    gen = torch.Generator()
    load_train_checkpoint(ckpt, state, gen, rank=0, world=2)
    _assert_identical(whole_train_state(state, gen), ranks[0]["state"], "checkpoint vs rank 0")
    save_train_checkpoint(tmp_path / "again", cfg["model"], state, gen, {"seed": 0})
    wait_for_checkpoints()
    assert (tmp_path / "again" / "model.pt").read_bytes() == (ckpt / "model.pt").read_bytes()
    assert (tmp_path / "again_ema" / "model.pt").read_bytes() == \
        (ckpt.with_name(ckpt.name + "_ema") / "model.pt").read_bytes()
    a, b = (torch.load(p / "train_state.pt", weights_only=True) for p in (tmp_path / "again", ckpt))
    assert len(b["gens"]) == 2 and torch.equal(b["gens"][0], b["gen"]) and torch.equal(a["gen"], b["gen"])
    del a["gens"], b["gens"]
    _assert_same_content(a, b, "train_state.pt")
    model = MoGeModel.from_pretrained(ckpt / "model.pt", device="cpu", dtype=torch.float32)
    assert model.infer(torch.rand(56, 70, 3), num_tokens=20)["depth"].shape == (56, 70)


def test_fsdp_round_trip_and_resume_are_bit_for_bit(fsdp, config, tmp_path):
    """FSDP resumes exactly: the last checkpoint loaded back on two ranks
    (no step left to run) is each rank's state bit for bit, generators
    included; two resumes from it run the next step to identical states."""
    tmp, ranks, _ = fsdp
    ckpt = str(tmp / "ws" / "checkpoints" / str(STEPS - 1))
    back, _ = _two_ranks(tmp_path / "back", config, tmp_path / "ws_back", "--num_iterations", str(STEPS), "--fsdp",
                         "2", "--checkpoint", ckpt)
    for r in range(2):
        assert back[r]["steps"] == []
        _assert_identical(back[r]["state"], ranks[r]["state"], f"round trip, rank {r}")
    resumed = [_two_ranks(tmp_path / name, config, tmp_path / f"ws_{name}", "--num_iterations", str(STEPS + 1),
                          "--fsdp", "2", "--checkpoint", ckpt)[0] for name in ("a", "b")]
    for r in range(2):
        assert [s["step"] for s in resumed[0][r]["steps"]] == [STEPS]
        assert resumed[0][r]["state"]["scalars"]["count"] == STEPS + 1
        _assert_identical(resumed[0][r]["state"], resumed[1][r]["state"], f"two resumes, rank {r}")


def test_fsdp_accumulates_and_draws_pictures(config, tmp_path):
    """FSDP with two micro-batches a step and ``--vis_every 1``: the
    pictures' no-grad forward leaves the root unit gathered (its parameters
    swapped for the gathered ones), and the next step still hands every
    rank's update the sharded, reduced gradients; rank 0 alone writes the
    pictures, of its share of the batch, and the ranks end equal."""
    ranks, _ = _two_ranks(tmp_path, config, tmp_path / "ws", "--num_iterations", str(STEPS), "--fsdp", "2",
                          "--gradient_accumulation_steps", "2", "--vis_every", "1")
    _assert_identical(ranks[0]["state"], ranks[1]["state"], "fsdp ranks", same_gen=False)
    assert [len(s["sizes"]) for s in ranks[0]["steps"]] == [2] * STEPS
    assert ranks[0]["state"]["scalars"]["count"] == STEPS
    assert sorted(p.name for p in (tmp_path / "ws" / "vis").iterdir()) == [str(i) for i in range(STEPS)]
    assert len(list((tmp_path / "ws" / "vis" / "0").iterdir())) == 3  # 3 pictures of rank 0's one instance


def test_default_run_over_local_ranks_is_the_multihost_run(dp, config, tmp_path):
    """The command's run over local ranks (``spawn`` of ``train_rank``, a
    file rendezvous) on two CPU ranks: rank 0's checkpoint is the
    ``--multihost`` run's, bit for bit."""
    tmp, _, _ = dp
    kwargs = dict(config_path=config, workspace=tmp_path / "ws", batch_size_forward=2, gradient_accumulation_steps=1,
                  num_iterations=STEPS, save_every=1, log_every=1, checkpoint_arg=None, backbone_checkpoint=None,
                  enable_ema=True, seed=0, num_tokens_quantum=4, image_size_quantum=32, vis_every=0)
    spawn(_fp32_train_rank, 2, "cpu", tmp_path / "rendezvous", ("cpu", 1, kwargs))
    for name in ("model.pt", "train_state.pt"):
        got, want = (ws / "checkpoints" / str(STEPS - 1) / name for ws in (tmp_path / "ws", tmp / "ws"))
        assert got.read_bytes() == want.read_bytes(), name
    assert not (tmp_path / "rendezvous").exists()


def _assert_same_content(a, b, where):
    """Equal nested dicts and lists, tensors equal in dtype, shape, strides and values."""
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same_content(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_content(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert (a.dtype, a.shape, a.stride()) == (b.dtype, b.shape, b.stride()) and torch.equal(a, b), where
    else:
        assert a == b, where


def _fp32_train_rank(*args):
    train.COMPUTE_DTYPE = torch.float32
    torch.set_num_threads(1)
    train.train_rank(*args)


def _cache_check(rank, world, seen):
    """One rank of test_sharded_module_forgets_its_derived_weights."""
    from torch.distributed.fsdp import FSDPModule

    from moge_tpu_torch.models.v2 import MoGeV2
    from moge_tpu_torch.parallel.distributed import Parallel
    from moge_tpu_torch.parallel.mesh import local, shard_params, whole

    torch.set_num_threads(1)
    ranks = Parallel.join(2, torch.device("cpu"))
    module = shard_params(MoGeV2(**TINY_CONFIG).init_random(seed=0), ranks.mesh)
    image = torch.rand(1, 56, 56, 3, generator=torch.Generator().manual_seed(rank))

    def cached():
        return {(id(m), k): id(v[1]) for m in module.modules() for k, v in m.__dict__.get("_derived", {}).items()}

    reused = []
    for _ in range(4):  # a training step's forward and backward, its update, the pictures' forward
        module(image, 16, torch.float32)["points"].square().mean().backward()
        with torch.no_grad():
            for p in module.parameters():
                local(p).mul_(0.9).add_(0.01)
                p.grad = None
            before = cached()
            got = module(image, 16, torch.bfloat16)["points"]
            reused.append(sum(cached().get(k) == v for k, v in before.items()))
        for sub in module.modules():
            if isinstance(sub, FSDPModule):
                sub.reshard()
    reference = MoGeV2(**TINY_CONFIG)
    reference.load_state_dict({k: whole(v) for k, v in module.state_dict().items()})
    with torch.no_grad():
        want = reference(image, 16, torch.bfloat16)["points"]
    torch.save({"reused": reused, "equal": torch.equal(got, want), "entries": len(cached())}, seen / f"{rank}.pt")


def test_sharded_module_forgets_its_derived_weights(tmp_path):
    """A no-grad forward of an FSDP module (the training command's pictures)
    after an update of its shards computes every derived weight afresh:
    FSDP2 gathers the parameters into storage it may reallocate at the same
    address and keeps their version counters, which the derived-weight
    cache's key is made of (without the units' cache drop, 6 to 26 of its
    157 entries were reused stale over these four rounds, in every run).
    Each rank's last output equals an unsharded module's with the gathered
    weights."""
    spawn(_cache_check, 2, "cpu", tmp_path / "rendezvous", (tmp_path,))
    for rank in range(2):
        seen = torch.load(tmp_path / f"{rank}.pt")
        assert seen["entries"] > 0 and seen["reused"] == [0] * 4 and seen["equal"], (rank, seen)


def _sharded_step_rank(rank, world, fsdp, tmp):
    """One rank of test_parallel_step_equals_jaxs_sharded_step: the bridged
    tiny MoGe-2 on a (dp, fsdp) mesh of gloo ranks, one optimizer step
    (``train_iteration``: the grad step on this rank's share, the mean over
    dp, the clip, the NaN check, AdamW and the EMA); rank 0 writes the
    gathered state and the logged record."""
    from moge_tpu_torch.models.v2 import MoGeV2
    from moge_tpu_torch.parallel.distributed import Parallel
    from moge_tpu_torch.parallel.mesh import shard_params
    from moge_tpu_torch.train.step import init_train_state, make_apply_step, make_grad_step
    from moge_tpu_torch.train.utils import build_optimizer

    torch.set_num_threads(1)
    case = torch.load(tmp / "case.pt", weights_only=False)
    ranks = Parallel.join(fsdp, torch.device("cpu"))
    module = MoGeV2(**TINY_CONFIG)
    module.load_state_dict(case["state_dict"], strict=True)
    if ranks.shard:
        shard_params(module, ranks.mesh)
    tx = build_optimizer(module, case["optimizer"], case["lr_scheduler"], max_grad_norm=case["clip"])
    state, gen = init_train_state(module, tx), torch.Generator()
    share = shard_batch(case["batch"], rank, world)
    grad_step = make_grad_step(module, case["loss"], case["label_types"], 16, torch.float32, ranks)
    state, record, _ = train.train_iteration(state, grad_step, make_apply_step(tx), lambda: share, 1, gen, ranks)
    whole = whole_train_state(state, gen)
    if rank == 0:
        torch.save({"state": whole, "record": record, "mesh": (ranks.dp, ranks.fsdp)}, tmp / "rank0.pt")


def test_parallel_step_equals_jaxs_sharded_step(tmp_path):
    """The port's step on four gloo ranks, a (dp=2, fsdp=2) mesh, against
    the JAX package's train step sharded over four host devices on
    ``make_mesh``'s mesh of the same shape: tests/test_torch_train.py's tiny
    MoGe-2 and loss table (no random draw), its batch made 4 (label types A
    and B alternating, one instance a rank), its weights bridged, v2.json's
    schedule and a clip of 1e-3, which binds. The logged metrics (the mean
    over ranks; the std over every rank's points) against JAX's
    global-batch values and the agreed grads_ok at test_torch_train's
    tolerances; the updated parameters and EMA within its STEP_TOL."""
    import jax
    import jax.numpy as jnp

    from moge_tpu.models.v2 import MoGeV2 as JaxMoGeV2
    from moge_tpu.parallel.mesh import make_mesh, shard_batch as jax_shard_batch, shard_params as jax_shard_params
    from moge_tpu.train import step as jstep
    from moge_tpu.train import utils as jutils
    from moge_tpu_torch.models.v2 import MoGeV2
    from moge_tpu_torch.train.step import make_grad_step
    from test_torch_train import _DRYRUN_OPT, _LABEL_TYPES, _LOSS_CONFIG, STEP_TOL, _batch
    from torch_tiny_config import state_dict_from_jax_params

    clip, world, fsdp = 1e-3, 4, 2
    module = JaxMoGeV2(**TINY_CONFIG, dtype=jnp.float32)
    params = jax.jit(module.init, static_argnums=(2,))(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)), 16)["params"]
    params = jax.tree.map(np.asarray, params)
    batch = {k: np.concatenate([v, v[::-1]]) if k != "label_type_idx" else np.tile(v, 2)
             for k, v in _batch(b=2).items()}
    mesh = make_mesh(jax.devices()[:world], fsdp=fsdp)
    assert dict(mesh.shape) == {"dp": 2, "fsdp": 2}
    tx = jutils.build_optimizer(params, _DRYRUN_OPT, V2["lr_scheduler"], max_grad_norm=clip)
    step = jax.jit(jstep.make_train_step(module, tx, _LOSS_CONFIG, _LABEL_TYPES, 16))
    with mesh:
        state_j, metrics_j = step(jstep.init_train_state(jax_shard_params(params, mesh), tx),
                                  jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh),
                                  jax.random.PRNGKey(1))
    metrics_j = {k: float(v) for k, v in metrics_j.items()}

    weights = state_dict_from_jax_params(TINY_CONFIG, params)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    one = MoGeV2(**TINY_CONFIG)
    one.load_state_dict(weights, strict=True)
    grads, _ = make_grad_step(one, _LOSS_CONFIG, _LABEL_TYPES, 16, torch.float32)(tensors, torch.Generator())
    assert torch.stack([g.square().sum() for g in grads.values()]).sum().sqrt() > 10 * clip  # the clip binds
    torch.save({"state_dict": weights, "optimizer": _DRYRUN_OPT, "lr_scheduler": V2["lr_scheduler"], "clip": clip,
                "loss": _LOSS_CONFIG, "label_types": _LABEL_TYPES, "batch": tensors}, tmp_path / "case.pt")
    spawn(_sharded_step_rank, world, "cpu", tmp_path / "rendezvous", (fsdp, tmp_path))
    got = torch.load(tmp_path / "rank0.pt", weights_only=False)

    assert got["mesh"] == (2, 2)
    record = got["record"]
    assert set(record) == set(metrics_j) and record["grads_ok"] == metrics_j["grads_ok"] == 1.0
    for k, want in metrics_j.items():
        assert record[k] == pytest.approx(want, rel=1e-4, abs=1e-6), k
    tensors = got["state"]["tensors"]
    for prefix, tree in (("model", state_j.params), ("ema", state_j.ema_params)):
        want = state_dict_from_jax_params(TINY_CONFIG, jax.tree.map(np.asarray, tree))
        for name, w in want.items():
            if f"ema.{name}" not in tensors:  # frozen (not trained): no EMA entry
                continue
            torch.testing.assert_close(tensors[f"{prefix}.{name}"], w, rtol=0, atol=STEP_TOL,
                                       msg=lambda m: f"{prefix}.{name}: {m}")
