"""The (dp, fsdp) device mesh and the sharding of a model on it (port of
moge_tpu/parallel/mesh.py).

The JAX package shards the batch over dp x fsdp and each parameter's
largest divisible axis over fsdp, and XLA inserts the gradient psum, the
all-gathers and the reduce-scatters. The port builds the same mesh as a 2-D
``DeviceMesh`` over the ranks (one per card) and shards with FSDP2's
``fully_shard`` on the mesh's ``fsdp`` axis: each ViT block, the neck, each
head and the root is one unit, its parameters cut along dim 0 (ZeRO-3),
gathered before the unit runs and its gradients reduce-scattered (averaged
over the fsdp group) in the backward. The average over ``dp`` is one
explicit all-reduce per optimizer step (``Parallel.mean_grads``), after
gradient accumulation. ``fsdp`` = 1 shards nothing (plain data
parallelism) unless the run asks for the sharded path on groups of one
(``Parallel.join(..., shard=True)``).

Sharded parameters, their gradients, the AdamW moments and the EMA are
DTensors, gathered and cut by DTensor's own redistribution (``whole``,
``distribute_like``). It runs through the functional collectives, which
crash the process over gloo with CUDA tensors: a sharded run on cards
needs NCCL, and gloo serves sharded runs on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

__all__ = ["make_mesh", "shard_params", "shard_batch", "replicate", "local", "like", "whole", "distribute_like"]


def make_mesh(fsdp: int = 1, dp: Optional[int] = None, device_type: str = "cuda"):
    """The ('dp', 'fsdp') ``DeviceMesh`` over every rank of the process
    group: each fsdp group is ``fsdp`` ranks of one host
    (``layout_multihost_devices``, the hosts told apart by name), dp across
    them. Every rank must call (it gathers the host names)."""
    import socket

    from torch.distributed.device_mesh import DeviceMesh

    from .distributed import layout_multihost_devices

    world = dist.get_world_size()
    if dp is None:
        if world % fsdp:
            raise ValueError(f"{world} processes not divisible by fsdp={fsdp}")
        dp = world // fsdp
    if dp * fsdp != world:
        raise ValueError(f"dp*fsdp ({dp}*{fsdp}) != processes ({world})")
    hosts: list = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    order = {h: i for i, h in enumerate(dict.fromkeys(hosts))}
    grid = layout_multihost_devices(range(world), fsdp, lambda r: order[hosts[r]])
    return DeviceMesh(device_type, torch.tensor(grid.astype(int)), mesh_dim_names=("dp", "fsdp"))


def _drop_derived(module: nn.Module, *_) -> None:
    """Forget the cached derived weights of a unit about to run. FSDP2
    gathers a unit's parameters into storage it frees after use and may
    reallocate at the same address, and it keeps their version counters:
    the cache's key (version, address) cannot see the new values."""
    for sub in module.modules():
        sub.__dict__.pop("_derived", None)


def _units(module: nn.Module) -> Iterable[nn.Module]:
    from ..models.dinov2 import DinoVisionTransformer

    for sub in module.modules():
        if isinstance(sub, DinoVisionTransformer):
            yield from sub.blocks
    for name in ("neck", "points_head", "normal_head", "mask_head", "scale_head", "head"):
        if isinstance(getattr(module, name, None), nn.Module):
            yield getattr(module, name)


def shard_params(module: nn.Module, mesh) -> nn.Module:
    """Shard a MoGe-1 or MoGe-2 module over ``mesh['fsdp']`` in place: one
    FSDP2 unit per ViT block, the neck, each head (v2's points, normal,
    mask and scale heads; v1's one head) and the root. Each unit drops its
    derived-weight cache when it runs (``_drop_derived``)."""
    from torch.distributed.fsdp import fully_shard

    for unit in [*_units(module), module]:
        fully_shard(unit, mesh=mesh["fsdp"])
        unit.register_forward_pre_hook(_drop_derived)
    return module


def shard_batch(batch: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """This rank's share of a global batch (over dp x fsdp, in rank order):
    every entry with a leading batch axis (arrays, tensors, lists) cut to
    ``local_share``, the rest as it is. The training loader loads only the
    share (``TrainDataLoaderPipeline(rank=, world=)``); this cuts a batch
    already made whole."""
    from .distributed import local_share

    out = {}
    for k, v in batch.items():
        size = len(v) if isinstance(v, (list, tuple)) else (v.shape[0] if getattr(v, "ndim", 0) else None)
        out[k] = v if size is None else v[local_share(size, rank, world)]
    return out


@torch.no_grad()
def replicate(module: nn.Module) -> nn.Module:
    """Every parameter and buffer of an unsharded ``module`` set to rank 0's."""
    for t in [*module.parameters(), *module.buffers()]:
        dist.broadcast(t.data, src=0)
    return module


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor; a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def like(ref: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t``, this rank's shard, as a tensor sharded like ``ref``."""
    if not isinstance(ref, DTensor):
        return t
    return DTensor.from_local(t, ref.device_mesh, ref.placements, run_check=False, shape=ref.shape,
                                 stride=ref.stride())


def whole(t: torch.Tensor) -> torch.Tensor:
    """The whole of a sharded tensor, gathered on every rank of its mesh
    (``DTensor.full_tensor``, a collective); a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def distribute_like(full: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A whole tensor, held alike on every rank, sharded like ``ref`` on
    ``ref``'s device (``distribute_tensor``: rank 0's copy is scattered);
    as it is when ``ref`` is not sharded."""
    if not isinstance(ref, DTensor):
        return full
    return distribute_tensor(full.to(ref.device), ref.device_mesh, ref.placements)
