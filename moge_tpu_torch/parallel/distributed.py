"""Multi-process training: the process group, the rank layout and each
rank's share of a batch (port of moge_tpu/parallel/distributed.py).

The JAX package runs one process per host, owning every local device, and
lays a (dp, fsdp) mesh over all hosts' devices. The port runs one process
per card, PyTorch's idiom: a ``torch.distributed`` process group (NCCL
between cards, gloo on the CPU), rank r on local card r modulo the host's
card count. The layout rule carries over: the ``fsdp`` axis lies within
one host, so its per-use
all-gathers and reduce-scatters stay on the host's links, and ``dp`` spans
hosts, so only the gradient all-reduce crosses them.

The global batch is the single-process batch: every rank runs the same
sampler on the same stream, draws the whole batch's descriptors and loads
only its share (``local_share``). The token count and the image size come
from streams every rank seeds alike, so they agree with no collective (the
JAX package's rule for its host-side draws). The losses' random anchors
come from a generator per rank (``loss_seed``).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_method", "initialize_distributed", "layout_multihost_devices", "local_share", "loss_seed",
           "Parallel", "spawn"]


def init_method(address: str) -> str:
    """``host:port`` -> a TCP rendezvous URL; a URL (``tcp://``, ``file://``) as it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize_distributed(coordinator_address: Optional[str], num_processes: Optional[int],
                           process_id: Optional[int], backend: str) -> bool:
    """Join the job's process group as rank ``process_id`` of
    ``num_processes`` through the rendezvous at ``coordinator_address``.
    Nothing on a GPU host tells a process of its job, so all three are
    required. Returns False when a group already exists (it is kept), True
    when this call made one."""
    if dist.is_initialized():
        return False
    missing = [name for name, v in (("coordinator_address", coordinator_address), ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(f"a multi-process run needs {', '.join(missing)}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not a rank of {num_processes} processes")
    dist.init_process_group(backend, init_method=init_method(coordinator_address), world_size=num_processes,
                            rank=process_id)
    return True


def layout_multihost_devices(devices: Sequence, fsdp: int, process_index_of: Optional[Callable] = None) -> np.ndarray:
    """Arrange devices into a (dp, fsdp) grid whose fsdp groups each lie in
    one host: rows are fsdp-sized consecutive chunks of each host's local
    devices, hosts in order. ``process_index_of(device)`` names a device's
    host (default: its ``process_index``)."""
    if process_index_of is None:
        process_index_of = lambda d: d.process_index  # noqa: E731
    by_proc = defaultdict(list)
    for d in devices:
        by_proc[process_index_of(d)].append(d)
    rows = []
    for proc in sorted(by_proc):
        local = by_proc[proc]
        if len(local) % fsdp != 0:
            raise ValueError(
                f"host {proc} has {len(local)} local devices, not divisible by fsdp={fsdp}; "
                "the fsdp axis must fit within one host so its collectives stay on ICI"
            )
        rows.extend(local[i: i + fsdp] for i in range(0, len(local), fsdp))
    return np.asarray(rows, dtype=object)


def local_share(global_batch: int, rank: int, world: int) -> slice:
    """The instances of a global batch that rank ``rank`` of ``world`` loads."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by {world} processes")
    n = global_batch // world
    return slice(rank * n, (rank + 1) * n)


def loss_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s loss generator: ``seed`` itself on rank 0,
    so a single-process run draws as before."""
    return seed + (rank << 32)


@dataclasses.dataclass
class Parallel:
    """This process's place in a training job: its rank, the world size,
    the (dp, fsdp) ``DeviceMesh``, its device, and whether the module is
    sharded over the mesh's fsdp axis. Without a mesh (a single-process
    run) every method below is the identity and runs no collective; with
    one, each runs its collective even over one rank."""

    rank: int = 0
    world: int = 1
    mesh: Any = None
    device: torch.device = torch.device("cpu")
    shard: bool = False

    @classmethod
    def join(cls, fsdp: int, device: torch.device, shard: Optional[bool] = None) -> "Parallel":
        """This rank of the initialized process group, on a (dp, fsdp) mesh
        over all of its ranks (``mesh.make_mesh``). ``shard`` defaults to
        ``fsdp`` > 1; True shards even over fsdp groups of one rank (the
        sharded code path on a single card)."""
        from .mesh import make_mesh

        mesh = make_mesh(fsdp, device_type=device.type)
        return cls(dist.get_rank(), dist.get_world_size(), mesh, device, fsdp > 1 if shard is None else shard)

    @property
    def dp(self) -> int:
        return 1 if self.mesh is None else self.mesh.size(0)

    @property
    def fsdp(self) -> int:
        return 1 if self.mesh is None else self.mesh.size(1)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def mean_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Gradients averaged over ``dp``: one all-reduce of every gradient
        (each rank's own shard under FSDP) flattened into one buffer."""
        if self.mesh is None:
            return grads
        from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

        from .mesh import like, local

        names = list(grads)
        parts = [local(grads[n]) for n in names]
        flat = _flatten_dense_tensors(parts)
        dist.all_reduce(flat, group=self.mesh.get_group("dp"))
        flat /= self.dp
        return {n: like(grads[n], t) for n, t in zip(names, _unflatten_dense_tensors(flat, parts))}

    def std(self, x: torch.Tensor) -> torch.Tensor:
        """The population std of ``x`` over every rank's (equal-sized)
        share, as one process computes it over the whole batch: the shares'
        sums and sums of squares all-reduced in float64."""
        if self.mesh is None:
            return x.std(correction=0)
        x64 = x.detach().double()
        moments = torch.stack([x64.sum(), x64.square().sum(), x64.new_tensor(float(x.numel()))])
        dist.all_reduce(moments)
        mean = moments[0] / moments[2]
        return (moments[1] / moments[2] - mean * mean).clamp_min(0).sqrt().float()

    def mean_metrics(self, record: Dict[str, float]) -> Dict[str, float]:
        """Each metric averaged over the ranks (each rank's is the mean over
        its equal share of the global batch)."""
        if self.mesh is None:
            return record
        keys = sorted(record)
        t = torch.tensor([record[k] for k in keys], dtype=torch.float64, device=self.device)
        dist.all_reduce(t)
        return dict(zip(keys, (t / self.world).tolist()))

    def gather(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in rank order."""
        if self.mesh is None:
            return [obj]
        out: List[Any] = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()


def _spawned(rank: int, fn: Callable, world: int, url: str, backend: str, device_type: str, args: tuple) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=url, world_size=world, rank=rank)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, device_type: str, rendezvous: Path, args: tuple = ()) -> None:
    """Run ``fn(rank, world, *args)`` in ``nprocs`` fresh processes (the
    spawn start method), one per local card on ``cuda``, joined in one
    process group (NCCL on ``cuda``, gloo on ``cpu``) through a file
    rendezvous at ``rendezvous``. Raises if a process fails."""
    import torch.multiprocessing as mp

    rendezvous = Path(rendezvous).resolve()
    rendezvous.unlink(missing_ok=True)
    backend = "nccl" if device_type == "cuda" else "gloo"
    try:
        mp.start_processes(_spawned, args=(fn, nprocs, f"file://{rendezvous}", backend, device_type, args),
                           nprocs=nprocs, start_method="spawn")
    finally:
        rendezvous.unlink(missing_ok=True)
