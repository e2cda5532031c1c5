"""Checkpoints of the port's models (port of moge_tpu/models/io.py).

``load_checkpoint`` reads a reference-format ``.pt`` file
(``{'model_config', 'model'}``, the microsoft/MoGe layout, which the port's
modules take with ``load_state_dict(strict=True)`` and no renames) with
``torch.load(weights_only=True)``. It serves both ``from_pretrained``s.
The JAX package's own Orbax checkpoint directories are not read here.

Training checkpoints (the JAX package's ``save_train_checkpoint`` /
``load_train_checkpoint``, with torch files in place of Orbax): a directory
``checkpoints/<step>/`` holding ``model.pt`` (the reference layout, so the
directory's model loads for inference) and ``train_state.pt`` (the AdamW
state, the optimizer's update count, the EMA, the step and the loss
generators' states, one per rank), and beside it ``<step>_ema/model.pt``,
the EMA weights as an inference checkpoint. The optimizer and the EMA update
the tensors in place, so a save first copies everything to host memory (the
snapshot) and then writes the files in a background thread;
``wait_for_checkpoints`` joins it. Each save returns a record of its
snapshot and write seconds.

In a multi-process run every rank takes part in a save and a load: a
tensor sharded by FSDP is gathered whole on every rank, and rank 0 alone
writes the files, in the same layout and bytes as a single-process run's.
A load gives each rank the whole tensors and each keeps the rows of its
shard.
"""

from __future__ import annotations

import threading
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["load_checkpoint", "snapshot_train_state", "restore_train_state", "save_train_checkpoint",
           "load_train_checkpoint", "wait_for_checkpoints"]

# the background writes not yet joined, with their records
_WRITERS: List[Tuple[threading.Thread, Dict[str, Any]]] = []


def load_checkpoint(path, version: str = "v2") -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """A local MoGe checkpoint -> (model_config, state_dict) on the CPU."""
    if version not in ("v1", "v2"):
        raise ValueError(f"Unknown model version: {version}")
    p = Path(str(path))
    if p.is_dir():
        raise ValueError(f"{p} is a directory: the port reads reference .pt checkpoints (a training checkpoint's "
                         "is its model.pt), not the JAX package's Orbax checkpoint directories")
    if not p.is_file():
        raise FileNotFoundError(f"no checkpoint at {p} (the port loads local .pt files; download a hub "
                                "checkpoint's model.pt first)")
    ckpt = torch.load(p, map_location="cpu", weights_only=True)
    return dict(ckpt["model_config"]), ckpt["model"]


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that later in-place updates of ``t`` do not reach."""
    return t.detach().to("cpu", copy=True)


def snapshot_train_state(state, gen: torch.Generator, keep: bool = True) -> Dict[str, Any]:
    """Host copies of a ``TrainState`` and the loss generator: the module's
    state dict, the optimizer (AdamW state dict and update count), the EMA,
    the step and the generator state. Sharded tensors are gathered whole,
    so under FSDP every rank must call; ``keep`` False (a rank that writes
    nothing) takes part in the gathers and keeps no copy."""
    from ..parallel.mesh import whole

    def host(t):
        t = whole(t)
        return _host(t) if keep else None

    opt = state.optimizer.state_dict()
    opt["adamw"]["state"] = {i: {k: host(v) for k, v in s.items()} for i, s in opt["adamw"]["state"].items()}
    return {
        "model": {k: host(v) for k, v in state.module.state_dict().items()},
        "optimizer": opt,
        "ema": None if state.ema_params is None else {k: host(v) for k, v in state.ema_params.items()},
        "step": int(state.step),
        "gen": gen.get_state().clone(),
    }


def _load_module(module, state_dict: Dict[str, torch.Tensor]) -> None:
    """``module.load_state_dict(state_dict, strict=True)``; a sharded (FSDP)
    module through the distributed checkpoint's full-state-dict load, each
    rank keeping its shards."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(p, DTensor) for p in module.parameters()):
        module.load_state_dict(state_dict, strict=True)
        return
    from torch.distributed.checkpoint.state_dict import StateDictOptions, set_model_state_dict

    set_model_state_dict(module, dict(state_dict), options=StateDictOptions(full_state_dict=True, strict=True))


def restore_train_state(state, gen: torch.Generator, snap: Dict[str, Any], rank: int = 0, world: int = 1) -> None:
    """Load a ``snapshot_train_state`` into ``state`` and ``gen`` in place
    (the tensors keep their device, identity and sharding). Rank ``rank``
    of ``world`` takes its own loss generator from a checkpoint of as many
    ranks; from one of another size it keeps ``gen`` as it is, with a
    warning."""
    from ..parallel.mesh import distribute_like

    _load_module(state.module, snap["model"])
    state.optimizer.load_state_dict(snap["optimizer"])
    if state.ema_params is not None:
        if snap["ema"] is None or set(snap["ema"]) != set(state.ema_params):
            raise ValueError("the checkpoint's EMA does not cover this run's trainable parameters")
        with torch.no_grad():
            for k, e in state.ema_params.items():
                e.copy_(distribute_like(snap["ema"][k], e))
    state.step = int(snap["step"])
    gens = snap.get("gens") or [snap["gen"]]
    if len(gens) == world:
        gen.set_state(gens[rank])
    else:
        warnings.warn(f"the checkpoint holds the loss generators of {len(gens)} ranks and this run has {world}: "
                      f"rank {rank} keeps its own")


def _ema_state_dict(model_sd: Dict[str, torch.Tensor], ema: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: ema.get(k, v) for k, v in model_sd.items()}


def _write(path: Path, config: Dict[str, Any], snap: Dict[str, Any], data_state, record: Dict[str, Any]) -> None:
    """The writer thread: the three files, then ``record['write_s']``; an
    error goes into ``record['error']`` for ``wait_for_checkpoints``."""
    try:
        t0 = time.perf_counter()
        path.mkdir(parents=True, exist_ok=True)
        torch.save({"model_config": config, "model": snap["model"]}, path / "model.pt")
        torch.save({"optimizer": snap["optimizer"], "ema": snap["ema"], "step": snap["step"], "gen": snap["gen"],
                    "gens": snap["gens"], "data": data_state}, path / "train_state.pt")
        if snap["ema"] is not None:
            ema_dir = path.with_name(path.name + "_ema")
            ema_dir.mkdir(parents=True, exist_ok=True)
            torch.save({"model_config": config, "model": _ema_state_dict(snap["model"], snap["ema"])},
                       ema_dir / "model.pt")
        record["write_s"] = time.perf_counter() - t0
    except Exception as e:  # raised again by wait_for_checkpoints, in the training thread
        record["error"] = e


def save_train_checkpoint(path, config: Dict[str, Any], state, gen: torch.Generator,
                          data_state: Optional[Dict[str, Any]] = None, ranks=None) -> Dict[str, Any]:
    """Save the full training state under ``path`` (``checkpoints/<step>``)
    and the EMA under ``<path>_ema``. The previous save is joined first;
    the snapshot is taken now and written in a background thread.
    ``data_state`` (a small dict, e.g. the run's seed) is
    stored as given. ``ranks`` (a ``parallel.distributed.Parallel``) makes
    it one rank's part of a multi-process save: every rank gathers, rank 0
    writes. Returns this save's record: {"path", "snapshot_s", and
    "write_s" once written}; {} on the other ranks."""
    from ..parallel.distributed import Parallel

    ranks = ranks or Parallel()
    gens = ranks.gather(gen.get_state())
    wait_for_checkpoints()
    t0 = time.perf_counter()
    snap = snapshot_train_state(state, gen, keep=ranks.is_main)
    if not ranks.is_main:
        return {}
    snap["gens"] = gens
    record = {"path": str(path), "snapshot_s": time.perf_counter() - t0}
    writer = threading.Thread(target=_write, args=(Path(path), dict(config), snap, data_state, record),
                              name="checkpoint-writer")
    writer.start()
    _WRITERS.append((writer, record))
    return record


def wait_for_checkpoints() -> None:
    """Block until every background checkpoint write has finished; raise
    the error of one that failed."""
    while _WRITERS:
        writer, record = _WRITERS.pop(0)
        writer.join()
        if "error" in record:
            raise RuntimeError(f"checkpoint write to {record['path']} failed") from record["error"]


def load_train_checkpoint(path, state, gen: torch.Generator, rank: int = 0,
                          world: int = 1) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """Restore a training checkpoint directory onto a freshly built
    ``state`` (same config and optimizer config) and ``gen``, in place, as
    rank ``rank`` of ``world`` (``restore_train_state``). Returns
    (model_config, data_state). A directory with only ``model.pt``
    restores the parameters alone (fresh optimizer and EMA; the run goes on
    after the step the directory is named for), with a warning."""
    path = Path(path)
    ckpt = torch.load(path / "model.pt", map_location="cpu", weights_only=True)
    if not (path / "train_state.pt").exists():
        warnings.warn(f"{path} has no train_state.pt (params-only checkpoint); optimizer/EMA/schedule state "
                      "re-initialized: the resumed run is NOT a continuation of the original optimization.")
        _load_module(state.module, ckpt["model"])
        if state.ema_params is not None:
            named = dict(state.module.named_parameters())
            with torch.no_grad():
                for k, e in state.ema_params.items():
                    e.copy_(named[k].float())
        state.step = int(path.name) + 1 if path.name.isdigit() else 0
        return dict(ckpt["model_config"]), None
    train = torch.load(path / "train_state.pt", map_location="cpu", weights_only=True)
    restore_train_state(state, gen, {"model": ckpt["model"], **train}, rank, world)
    return dict(ckpt["model_config"]), train.get("data")
