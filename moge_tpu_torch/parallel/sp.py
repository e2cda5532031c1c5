"""Sequence-parallel inference: the ViT encoder's token axis split over the
ranks of a process group (port of moge_tpu/parallel/sp.py).

For the 2500-3600-token inference regime the encoder is the cost. Every
encoder op except attention is per token, so each rank runs one contiguous
chunk of the (padded) token axis, and attention gathers K and V from every
rank: one all-gather of 2 x N x D values per block. The parameters stay
whole on every rank (no resharding, checkpoints load as they are); the
patch embed and pos-embed run on every rank; the padding sits at the
global tail and is masked by K2's ``kv_valid``. The decoder, the epilogue
and the camera solve run replicated, so every rank returns the whole
result.

The port runs one process per card (``parallel/distributed.py``), so every
rank of the group calls ``MoGeModel.infer`` with the same inputs. A server
lives on the group's rank 0: ``Leader`` takes ``infer``'s arguments and
sends each call's arguments and images to the group before running it, and
the other ranks run ``follow(model)`` until the leader's ``stop``.

Collectives are plain c10d calls (``all_gather``, ``broadcast``), which
gloo takes for CPU and CUDA tensors alike and NCCL for CUDA tensors.
Inference only: the gathers have no backward (the ViT raises with grad
mode on).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = ["shard_tokens", "gather_tokens", "sequence_parallel_encode", "Leader", "follow"]


def shard_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous chunk of the (B, N, ...) token axis, zero-padded
    at the global tail to ranks x ceil(N / ranks) tokens."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[1]
    chunk = -(-n // world)
    pad = [0, 0] * (x.dim() - 2) + [0, chunk * world - n]
    return F.pad(x, pad)[:, rank * chunk:(rank + 1) * chunk].contiguous()


def gather_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's (B, n, ...) chunk, joined along the token axis in rank
    order: (B, ranks x n, ...). One all-gather into a (ranks, B, n, ...)
    buffer; the join is a view for B = 1."""
    world = dist.get_world_size(group)
    buf = x.new_empty((world, *x.shape))
    dist.all_gather(list(buf.unbind(0)), x.contiguous(), group=group)
    return buf.transpose(0, 1).flatten(1, 2)


def sequence_parallel_encode(vit, image: torch.Tensor, take_layers: Sequence[int], group,
                             dtype: torch.dtype = torch.float32):
    """Run a ``DinoVisionTransformer`` with the token axis split over
    ``group`` (every rank calls with the same ``image``, (B, 14*h, 14*w, 3)
    normalized NHWC). Returns ``vit``'s [(patch tokens, cls token), ...],
    whole on every rank."""
    with torch.inference_mode():
        return vit(image, take_layers, dtype, sp_group=group)


def _source(group) -> int:
    """The global rank of the group's rank 0, the leader."""
    return dist.get_global_rank(group, 0)


class Leader:
    """``model`` (a ``MoGeModel`` built with ``sp_group``) on rank 0 of its
    group, with ``infer``'s arguments: each call first broadcasts them and
    its images to the group, whose other ranks run ``follow``.
    ``stop`` ends their loops. Calls must come one at a time (the server's
    dispatch thread, or its warm-up before traffic)."""

    def __init__(self, model):
        if model.sp_group is None:
            raise ValueError("Leader needs a model built with sp_group")
        if dist.get_rank(model.sp_group) != 0:
            raise ValueError("the leader runs on rank 0 of the sequence-parallel group")
        self.model = model
        self.device = model.device

    def infer(self, image, **kwargs):
        if not isinstance(image, torch.Tensor):
            image = torch.as_tensor(np.asarray(image))
        image = image.to(self.device, torch.float32).contiguous()
        if isinstance(kwargs.get("fov_x"), torch.Tensor):
            kwargs["fov_x"] = kwargs["fov_x"].cpu()
        group = self.model.sp_group
        dist.broadcast_object_list([(tuple(image.shape), kwargs)], src=_source(group), group=group)
        dist.broadcast(image, src=_source(group), group=group)
        return self.model.infer(image, **kwargs)

    def stop(self) -> None:
        """Release the followers."""
        group = self.model.sp_group
        dist.broadcast_object_list([None], src=_source(group), group=group)


def follow(model) -> int:
    """The loop of a rank other than the leader: join each of the leader's
    ``infer`` calls with ``model`` (the same weights, built with the same
    ``sp_group``) until its ``stop``. A call that raises is passed over:
    every rank sees the same arguments, so the leader's call raises the same
    error (a rank that fails alone leaves the others waiting in a
    collective). Returns the number of calls joined."""
    group = model.sp_group
    calls = 0
    while True:
        message = [None]
        dist.broadcast_object_list(message, src=_source(group), group=group)
        if message[0] is None:
            return calls
        shape, kwargs = message[0]
        image = torch.empty(shape, dtype=torch.float32, device=model.device)
        dist.broadcast(image, src=_source(group), group=group)
        try:
            model.infer(image, **kwargs)
        except Exception:  # the leader's call raises the same error to its caller
            pass
        calls += 1
