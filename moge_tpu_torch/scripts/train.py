"""Training command (port of moge_tpu/scripts/train.py; reference
moge/scripts/train.py:66-461): MoGe-1 or MoGe-2 (the config's
``model_version``) from a training config, on one card or many.

The threaded, augmenting loader (``train/dataloader.py``) feeds batches of a
random size (area and aspect drawn per batch, quantised to
``--image_size_quantum`` pixels); each step runs at ``num_tokens_range[0]``
tokens up to ``low_resolution_training_steps``, then at a random count
quantised to ``--num_tokens_quantum``. A step is ``make_grad_step`` per
micro-batch (``--gradient_accumulation_steps``), the mean of their
gradients, and one ``make_apply_step`` update (the NaN-gradient skip, AdamW
with the clip, the EMA). All-invalid batches are skipped. Logs:
``metrics.jsonl`` (averages every ``--log_every`` steps) and
``steps.jsonl`` (per step: tokens, image sizes, label types, wall seconds,
seconds blocked on the loader, loss). Checkpoints (``models/io.py``):
``checkpoints/<step>/`` and ``<step>_ema/`` every ``--save_every`` steps and
at the last, written in the background; ``--checkpoint latest`` resumes the
full state.

Parallelism (``parallel/``), one process per card: with no
``--multihost`` the command trains over every visible CUDA device, as the
JAX command's default mesh does (one worker process per card, started here
with a file rendezvous in the workspace; one card, or ``--device cpu``,
trains in this process). With ``--multihost`` this process is rank
``--process_id`` of ``--num_processes`` joined at ``--coordinator``, on
local card ``process_id`` modulo the host's card count. ``--batch_size_forward``
is the global batch, split evenly over the ranks; ``--fsdp`` shards the
parameters, gradients, AdamW moments and EMA over groups of that many ranks
within a host (FSDP2), and the gradients are averaged over the data-parallel
ranks once per optimizer step. Rank 0 alone prints, writes the logs, the
pictures and the checkpoint files; every rank takes part in a save.

Random streams: the loader's sampler and the token draw each have their own
``random.Random`` seeded from ``--seed`` plus the first step, alike on every
rank (the JAX command draws both from the module-global ``random``, so its
data order after the low-resolution steps depends on thread timing), and
the losses' draws come from a ``torch.Generator`` per rank, seeded from
(seed, rank), that the checkpoint carries. A resumed run restores the train
state and the generators, and reseeds the data as the JAX command does: it
does not replay the data an uninterrupted run would have seen.

The JAX command's XLA and Pallas switches keep their defaults here and
refuse any other value.
"""

from __future__ import annotations

import json
import random
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["command", "main", "run", "train_rank", "resolve_checkpoint", "batch_to_device", "train_iteration"]

# the forward's and backward's dtype, as the JAX command's; parameters,
# optimizer state and EMA stay fp32
COMPUTE_DTYPE = torch.bfloat16

# JAX-only option -> (its default, why the port refuses another value)
JAX_ONLY = {
    "use_flash": (True, "the port always runs K2/K2b on the card"),
    "scan_blocks": (False, "shortens XLA compiles; the port has no compile step"),
    "split_loss_programs": ("auto", "works around a TPU runtime fault; the port runs one fused step"),
}


def resolve_checkpoint(ckpt_dir: Path, checkpoint_arg: Optional[str]) -> Optional[Path]:
    """``--checkpoint``: "latest" (the highest numbered directory under
    ``ckpt_dir``), a step number, or a path; None when it does not exist."""
    if checkpoint_arg is None:
        return None
    if checkpoint_arg == "latest":
        steps = sorted(int(p.name) for p in ckpt_dir.glob("[0-9]*") if p.is_dir() and p.name.isdigit())
        path = ckpt_dir / str(steps[-1]) if steps else None
    elif checkpoint_arg.isdigit():
        path = ckpt_dir / checkpoint_arg
    else:
        path = Path(checkpoint_arg)
    return path if path is not None and path.exists() else None


def batch_to_device(batch_np: Dict[str, Any], label_types: Sequence[str], device) -> Dict[str, torch.Tensor]:
    """A collated loader batch -> the train step's tensors on ``device``
    (label types as indices into ``label_types``, unknown ones 'invalid')."""
    arrays = {k: np.asarray(batch_np[k]) for k in ("image", "depth", "normal", "normal_mask", "depth_mask_fin",
                                                   "depth_mask_inf", "intrinsics", "is_metric")}
    arrays["label_type_idx"] = np.asarray(
        [label_types.index(lt) if lt in label_types else label_types.index("invalid")
         for lt in batch_np["label_type"]], np.int64)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def train_iteration(state, grad_step: Callable, apply_step: Callable, next_batch: Callable, micro_batches: int,
                    gen: torch.Generator, ranks=None):
    """One optimizer step: ``grad_step`` on ``micro_batches`` batches from
    ``next_batch()`` (each a dict of tensors), their gradients' mean, one
    ``apply_step``. With ``ranks`` (a ``parallel.distributed.Parallel``) the
    mean gradient is then averaged over the data-parallel ranks (one
    all-reduce) and the metrics over every rank. Returns (state, record:
    the metrics averaged over the micro-batches with 'grads_ok', the
    batches)."""
    from ..train.step import accumulate_grads, scale_grads
    from ..utils.tools import key_average

    grad_sum, records, batches = None, [], []
    for _ in range(micro_batches):
        batch = next_batch()
        grads, metrics = grad_step(batch, gen)
        grad_sum = grads if grad_sum is None else accumulate_grads(grad_sum, grads)
        records.append({k: float(v) for k, v in metrics.items()})
        batches.append(batch)
    if micro_batches > 1:
        grad_sum = scale_grads(grad_sum, float(micro_batches))
    record = key_average(records) if micro_batches > 1 else records[0]
    if ranks is not None:
        grad_sum = ranks.mean_grads(grad_sum)
        record = ranks.mean_metrics(record)
    state, grads_ok = apply_step(state, grad_sum)
    record["grads_ok"] = float(grads_ok)
    return state, record, batches


def _write_vis(out_dir: Path, module, batch: Dict[str, torch.Tensor], num_tokens: int, dtype,
               write: bool = True) -> None:
    """GT-vs-pred depth pictures of up to 4 instances of this rank's batch
    (reference train.py:426-454). Every rank runs the forward (a sharded
    module gathers its parameters); only ``write`` writes."""
    with torch.no_grad():
        pred_z = module(batch["image"], num_tokens, dtype)["points"][..., 2].float().cpu().numpy()
    if not write:
        return
    import cv2

    from ..utils.vis import colorize_depth

    out_dir.mkdir(parents=True, exist_ok=True)
    gt_depth = batch["depth"].cpu().numpy()
    images = batch["image"].cpu().numpy()
    for bi in range(min(4, images.shape[0])):
        cv2.imwrite(str(out_dir / f"{bi}_image.jpg"), cv2.cvtColor((images[bi] * 255).astype(np.uint8),
                                                                   cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(out_dir / f"{bi}_pred.png"), cv2.cvtColor(colorize_depth(pred_z[bi]), cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(out_dir / f"{bi}_gt.png"), cv2.cvtColor(colorize_depth(gt_depth[bi]), cv2.COLOR_RGB2BGR))


def train_rank(rank: int, world: int, device_type: str, fsdp: int, kwargs: Dict[str, Any]) -> None:
    """One worker of a run over the local ranks (``parallel.distributed.spawn``):
    ``run(**kwargs)`` as rank ``rank``, on card ``rank`` for 'cuda'."""
    from ..parallel.distributed import Parallel

    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device(device_type)
    run(device=device, ranks=Parallel.join(fsdp, device), **kwargs)


def command():
    """The ``train`` click command (click is imported here, not with the module)."""
    import click

    @click.command(help="Training script")
    @click.option("--config", "config_path", type=click.Path(exists=True), required=True, help="Training config JSON.")
    @click.option("--workspace", type=click.Path(), default="workspace/train",
                  help="Workspace directory for checkpoints/logs.")
    @click.option("--batch_size_forward", type=int, default=4,
                  help="Global batch size per forward pass, split evenly over the processes.")
    @click.option("--gradient_accumulation_steps", type=int, default=1)
    @click.option("--num_iterations", type=int, default=100000)
    @click.option("--save_every", type=int, default=5000)
    @click.option("--log_every", type=int, default=100)
    @click.option("--checkpoint", "checkpoint_arg", type=str, default=None,
                  help='"latest", a step number, or a checkpoint directory.')
    @click.option("--backbone_checkpoint", type=click.Path(exists=True), default=None,
                  help="DINOv2 hub-format .pth to initialize the backbone of a fresh run.")
    @click.option("--ema/--no-ema", "enable_ema", default=True)
    @click.option("--fsdp", type=int, default=1,
                  help="FSDP (parameter-sharding) mesh axis size: processes per shard group, within one host.")
    @click.option("--multihost", is_flag=True,
                  help="This process is one rank of a job launched by the user, one process per card: "
                       "--coordinator is the rendezvous, --num_processes the world size, --process_id the rank; "
                       "the card is process_id modulo the host's card count. batch_size_forward is the GLOBAL "
                       "batch.")
    @click.option("--coordinator", "--coordinator_address", "coordinator_address", type=str, default=None,
                  help="Multihost rendezvous: host:port (TCP), or a tcp:// or file:// URL.")
    @click.option("--num_processes", type=int, default=None, help="Multihost process count (the world size).")
    @click.option("--process_id", type=int, default=None, help="This process's rank.")
    @click.option("--seed", type=int, default=0)
    @click.option("--num_tokens_quantum", type=int, default=100, help="Bucket size for random per-step num_tokens.")
    @click.option("--image_size_quantum", type=int, default=32, help="Bucket (pixel multiple) for sampled image sizes.")
    @click.option("--vis_every", type=int, default=0, help="Dump GT-vs-pred depth visualizations every N steps (0 = off).")
    @click.option("--flash/--no_flash", "use_flash", default=True, show_default=True,
                  help="JAX package only (its XLA attention); the port always runs its kernels.")
    @click.option("--scan_blocks/--no_scan_blocks", default=False, help="JAX package only (XLA compiles); refused.")
    @click.option("--split_loss_programs", type=click.Choice(["auto", "on", "off"]), default="auto",
                  help="JAX package only (a TPU runtime fault); must stay auto.")
    @click.option("--device", "device_name", type=str, default="cuda", show_default=True,
                  help="Torch device; no fallback to the CPU when it is missing.")
    def train(config_path, workspace, batch_size_forward, gradient_accumulation_steps, num_iterations, save_every,
              log_every, checkpoint_arg, backbone_checkpoint, enable_ema, fsdp, multihost, coordinator_address,
              num_processes, process_id, seed, num_tokens_quantum, image_size_quantum, vis_every, use_flash,
              scan_blocks, split_loss_programs, device_name):
        import torch.distributed as dist

        from ..parallel.distributed import Parallel, initialize_distributed, spawn

        given = dict(use_flash=use_flash, scan_blocks=scan_blocks, split_loss_programs=split_loss_programs)
        for name, (default, why) in JAX_ONLY.items():
            if given[name] != default:
                raise click.UsageError(f"{name}={given[name]!r}: {why}")
        device = torch.device(device_name)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise click.UsageError(f"--device {device_name}: no CUDA device (no fallback to the CPU)")
        if fsdp < 1:
            raise click.UsageError(f"--fsdp {fsdp}: must be at least 1")
        kwargs = dict(config_path=Path(config_path), workspace=Path(workspace), batch_size_forward=batch_size_forward,
                      gradient_accumulation_steps=gradient_accumulation_steps, num_iterations=num_iterations,
                      save_every=save_every, log_every=log_every, checkpoint_arg=checkpoint_arg,
                      backbone_checkpoint=backbone_checkpoint, enable_ema=enable_ema, seed=seed,
                      num_tokens_quantum=num_tokens_quantum, image_size_quantum=image_size_quantum,
                      vis_every=vis_every)
        job = dict(coordinator_address=coordinator_address, num_processes=num_processes, process_id=process_id)
        if multihost:
            missing = [f"--{k}" for k, v in job.items() if v is None]
            if missing:
                raise click.UsageError(f"--multihost needs {', '.join(missing)} (nothing on a GPU host tells a "
                                       "process of its job)")
            if device.type == "cuda":
                device = torch.device("cuda", process_id % torch.cuda.device_count())
                torch.cuda.set_device(device)
            made = initialize_distributed(coordinator_address, num_processes, process_id,
                                          "nccl" if device.type == "cuda" else "gloo")
            try:
                return run(device=device, ranks=Parallel.join(fsdp, device), **kwargs)
            finally:
                if made:
                    dist.destroy_process_group()
        stray = [f"--{k}" for k, v in job.items() if v is not None]
        if stray:
            raise click.UsageError(f"{', '.join(stray)} describe a --multihost job")
        cards = torch.cuda.device_count() if device_name == "cuda" else 1
        if cards > 1:  # every visible card, one worker process each
            Path(workspace).mkdir(parents=True, exist_ok=True)
            spawn(train_rank, cards, "cuda", Path(workspace) / "rendezvous", ("cuda", fsdp, kwargs))
            return {"processes": cards}
        if fsdp != 1:
            raise click.UsageError(f"--fsdp {fsdp}: shards over {fsdp} processes, and this run has one")
        return run(device=device, **kwargs)

    return train


def _build_module(config: Dict[str, Any], device: torch.device):
    """The config's ``model_version`` ('v1' or 'v2', default v2) as a training
    module on ``device``, and the DINOv2 backbone inside it. Model keys
    outside the version's known set (``remat`` among them) are dropped, as
    the JAX command's ``MoGeModel`` and v1 ``normalize_config`` drop them."""
    version = config.get("model_version", "v2")
    with torch.device(device):
        if version == "v1":
            from ..models.v1 import MoGeV1, normalize_config

            module = MoGeV1(**normalize_config(config["model"]))
            return module, module.backbone
        if version == "v2":
            from ..models.v2 import MoGeModel, MoGeV2

            module = MoGeV2(**{k: v for k, v in config["model"].items() if k in MoGeModel._CONFIG_KEYS})
            return module, module.encoder.backbone
    raise ValueError(f"Unsupported model version: {version}")


def run(config_path: Path, workspace: Path, device: torch.device, batch_size_forward: int,
        gradient_accumulation_steps: int, num_iterations: int, save_every: int, log_every: int,
        checkpoint_arg: Optional[str], backbone_checkpoint: Optional[str], enable_ema: bool, seed: int,
        num_tokens_quantum: int, image_size_quantum: int, vis_every: int, ranks=None) -> Dict[str, Any]:
    """The command's body, as one rank of ``ranks`` (a
    ``parallel.distributed.Parallel``; None: a single process). Returns
    {'state', 'gen', 'steps': the steps.jsonl records of this run, 'saves':
    each checkpoint save's seconds (rank 0's)}."""
    from ..models.convert import load_dinov2_backbone
    from ..models.io import load_train_checkpoint, save_train_checkpoint, wait_for_checkpoints
    from ..parallel.distributed import Parallel, loss_seed
    from ..parallel.mesh import replicate, shard_params
    from ..train.dataloader import TrainDataLoaderPipeline
    from ..train.step import init_train_state, make_apply_step, make_grad_step
    from ..train.utils import build_optimizer
    from ..utils.tools import key_average

    ranks = ranks or Parallel(device=device)
    say = print if ranks.is_main else (lambda *a, **k: None)
    config = json.loads(config_path.read_text())
    workspace.mkdir(parents=True, exist_ok=True)
    dtype = COMPUTE_DTYPE
    module, backbone = _build_module(config, device)
    num_tokens_range = config["model"].get("num_tokens_range", [1200, 3600])

    ckpt_dir = workspace / "checkpoints"
    resume_path = resolve_checkpoint(ckpt_dir, checkpoint_arg)
    if resume_path is None:
        module.init_random(seed=seed)
        if backbone_checkpoint is not None:
            # pretrained-backbone init (reference init_weights, train.py:188-192), heads random
            load_dinov2_backbone(backbone, torch.load(backbone_checkpoint, map_location="cpu", weights_only=True))
            say(f"Initialized backbone from {backbone_checkpoint}; heads random")
        else:
            say("Initialized random weights (pass --backbone_checkpoint for pretrained "
                "DINOv2 backbone initialization)")
        if ranks.mesh is not None:
            replicate(module)
    if ranks.mesh is not None:
        say(f"mesh: dp={ranks.dp} x fsdp={ranks.fsdp}{', sharded' if ranks.shard else ''} "
            f"(process {ranks.rank}/{ranks.world}, {device})")
        if ranks.shard:
            shard_params(module, ranks.mesh)
    tx = build_optimizer(module, config["optimizer"], config.get("lr_scheduler"))
    state = init_train_state(module, tx, enable_ema=enable_ema)
    gen = torch.Generator(device=device).manual_seed(loss_seed(seed, ranks.rank))
    if resume_path is not None:
        load_train_checkpoint(resume_path, state, gen, ranks.rank, ranks.world)
        say(f"Resumed from {resume_path} at step {state.step}")
    initial_step = state.step

    # the data is reseeded from the first step, so a resumed run does not
    # replay the data order from step 0 (reference train.py:264-266)
    data_rng = random.Random(seed + initial_step)
    tokens_rng = random.Random(f"num_tokens/{seed + initial_step}")
    label_types = sorted(config["loss"].keys())
    apply_step = make_apply_step(tx)
    pipe = TrainDataLoaderPipeline(dict(config["data"]), batch_size_forward, data_rng,
                                   image_size_quantum=image_size_quantum, rank=ranks.rank, world=ranks.world)
    low_res_steps = config.get("low_resolution_training_steps", 0)
    records: List[Dict[str, float]] = []
    steps: List[Dict[str, Any]] = []
    saves: List[Dict[str, Any]] = []

    with pipe:
        wait = [0.0]  # seconds blocked on the loader in this step

        def next_batch():
            """Pull batches until the global batch has a non-invalid instance
            (reference train.py:278-279 skips all-invalid batches without
            counting them toward the accumulation); 'label_type' holds the
            global batch's, in rank order."""
            while True:
                t0 = time.perf_counter()
                batch_np = pipe.get()
                wait[0] += time.perf_counter() - t0
                lts = [lt for share in ranks.gather(batch_np["label_type"]) for lt in share]
                if not all(lt == "invalid" for lt in lts):
                    return {**batch_to_device(batch_np, label_types, device), "label_type": lts}

        t_start = time.time()
        for i_step in range(initial_step, num_iterations):
            t_step0 = time.perf_counter()
            wait[0] = 0.0
            if i_step <= low_res_steps:
                num_tokens = num_tokens_range[0]
            else:
                nt = tokens_rng.randint(*num_tokens_range)
                num_tokens = max(num_tokens_range[0], nt // num_tokens_quantum * num_tokens_quantum)
            grad_step = make_grad_step(module, config["loss"], label_types, num_tokens, dtype, ranks)
            state, record, batches = train_iteration(state, grad_step, apply_step, next_batch,
                                                     gradient_accumulation_steps, gen, ranks)
            if not np.isfinite(record.get("total", 0.0)):
                # NaN-loss report (reference train.py:326-328); the NaN-grad skip prevented the update
                say(f"NaN loss at step {i_step}: {record}")
            records.append(record)
            line = {"step": i_step, "num_tokens": num_tokens, "t": round(time.perf_counter() - t_step0, 4),
                    "total": round(record.get("total", float("nan")), 5), "data_wait": round(wait[0], 4),
                    "sizes": [list(b["image"].shape[1:3]) for b in batches],
                    "label_types": [list(b["label_type"]) for b in batches]}
            steps.append(line)
            if ranks.is_main:
                with (workspace / "steps.jsonl").open("a") as f:
                    f.write(json.dumps(line) + "\n")

            if i_step % log_every == 0 or i_step == initial_step:
                avg = key_average(records)
                elapsed = time.time() - t_start
                say(f"step {i_step}: loss={avg.get('total', float('nan')):.4f} "
                    f"({elapsed / max(len(records), 1):.2f}s/step) "
                    f"{json.dumps({k: round(v, 4) for k, v in avg.items() if v is not None})}")
                if ranks.is_main:
                    with (workspace / "metrics.jsonl").open("a") as f:
                        f.write(json.dumps({"step": i_step, **avg}) + "\n")
                records = []
                t_start = time.time()

            if vis_every and i_step % vis_every == 0:
                _write_vis(workspace / "vis" / str(i_step), module, batches[-1], num_tokens, dtype, ranks.is_main)

            if i_step > 0 and (i_step % save_every == 0 or i_step == num_iterations - 1):
                out = ckpt_dir / str(i_step)
                record = save_train_checkpoint(out, config["model"], state, gen, {"seed": seed}, ranks)
                if ranks.is_main:
                    saves.append(record)
                say(f"saved checkpoint at step {i_step} -> {out}")
    wait_for_checkpoints()
    ranks.barrier()
    return {"state": state, "gen": gen, "steps": steps, "saves": saves}


def main():
    command()()


if __name__ == "__main__":
    main()
