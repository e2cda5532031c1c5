"""MoGe-2 train step: loss dispatch, NaN-safe update, EMA (port of
moge_tpu/train/step.py, the fused step).

``make_train_step`` builds ``train_step(state, batch, gen)``: the training
forward of ``MoGeV2`` in the compute dtype (bf16 by default, parameters
fp32), the losses of the config's per-label-type tables, the backward, and
``make_apply_step``'s update: a NaN/Inf-gradient skip that leaves the
parameters and the optimizer state as they were, AdamW with the global-norm
clip, and the fp32 EMA. The parameters live in the module and are updated
in place; ``TrainState`` holds the module, the optimizer and the EMA.

On the card the forward runs kernels K1, K2 and K3, the backward K2b-dq and
K2b-dkv, and every truncated alignment solve of the losses K4. The JAX
package's split-program trainer exists for XLA only and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.alignment import align_points_scale_xyz_shift
from ..ops.geometry import depth_map_to_point_map
from ..parallel.mesh import whole
from . import losses as L
from .utils import Optimizer

__all__ = ["TrainState", "init_train_state", "compute_losses", "make_grad_step", "make_apply_step",
           "accumulate_grads", "scale_grads", "make_train_step"]

Grads = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    module: nn.Module
    optimizer: Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]]


def init_train_state(module: nn.Module, tx: Optimizer, enable_ema: bool = True) -> TrainState:
    """Step 0; the EMA starts as an fp32 copy of the trainable parameters."""
    ema = None
    if enable_ema:
        ema = {n: p.detach().float().clone() for n, p in module.named_parameters() if p.requires_grad}
    return TrainState(0, module, tx, ema)


def _loss_weights_per_instance(loss_config: Dict[str, Dict], label_types: Sequence[str]):
    """Each loss entry's spec, and its weight per label type. One entry name
    must have one spec across label types (only 'weight' may vary): the
    batch evaluates each entry once."""
    entries: Dict[str, Dict] = {}
    for table in loss_config.values():
        for name, spec in table.items():
            if name not in entries:
                entries[name] = spec
                continue
            prev = {k: v for k, v in entries[name].items() if k != "weight"}
            cur = {k: v for k, v in spec.items() if k != "weight"}
            if prev != cur:
                raise ValueError(f"loss entry {name!r} has differing specs across label types "
                                 f"({prev} vs {cur}); only per-label_type 'weight' may vary")
    weights = {name: [loss_config.get(lt, {}).get(name, {}).get("weight", 0.0) for lt in label_types]
               for name in entries}
    return entries, weights


def compute_losses(gen: torch.Generator, output: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                   loss_config: Dict[str, Dict], label_types: Sequence[str]) -> Tuple[torch.Tensor, Dict]:
    """Total scalar loss and metrics for a batch.

    ``batch``: depth (B, H, W), normal (B, H, W, 3) and normal_mask (when a
    normal_map loss is configured), depth_mask_fin/depth_mask_inf (B, H, W)
    bool, intrinsics (B, 3, 3), label_type_idx (B,) int index into
    ``label_types``, is_metric (B,) bool. Local-loss entries that share
    ``trunc`` and ``align_resolution`` are solved in one batched call."""
    entries, weight_table = _loss_weights_per_instance(loss_config, label_types)
    lt_idx = batch["label_type_idx"].long()
    dev = lt_idx.device
    weights = {n: torch.tensor(w, dtype=torch.float32, device=dev)[lt_idx] for n, w in weight_table.items()}

    gt_mask_fin = batch["depth_mask_fin"]
    # invalid targets -> inf points, which the losses' isfinite masks drop
    gt_points = torch.where(gt_mask_fin[..., None], depth_map_to_point_map(batch["depth"], batch["intrinsics"]),
                            torch.inf)
    fx, fy = batch["intrinsics"][..., 0, 0], batch["intrinsics"][..., 1, 1]
    gt_focal = 1.0 / torch.sqrt(1.0 / fx ** 2 + 1.0 / fy ** 2)  # diagonal-normalised

    pred_points = output.get("points")
    total = torch.zeros((), dtype=torch.float32, device=dev)
    metrics: Dict[str, torch.Tensor] = {}
    gt_metric_scale = None

    def add(name, loss_b, misc, w):
        nonlocal total
        total = total + (w * loss_b).mean()
        metrics[name] = loss_b.mean()
        metrics.update({f"{name}.{k}": v for k, v in misc.items()})

    # the global loss first: its scale feeds the metric-scale and local losses
    for name, spec in entries.items():
        if spec["function"] == "affine_invariant_global_loss":
            loss_b, misc, gt_metric_scale = L.affine_invariant_global_loss(pred_points, gt_points,
                                                                           **spec.get("params", {}))
            add(name, loss_b, misc, weights[name])

    local_results: Dict[str, Tuple] = {}
    local_names = [n for n, s in entries.items() if s["function"] == "affine_invariant_local_loss"]
    params = {n: entries[n].get("params", {}) for n in local_names}
    solver_key = lambda n: (params[n].get("trunc", 1.0), params[n].get("align_resolution", 32))  # noqa: E731
    if len(local_names) >= 2 and len({solver_key(n) for n in local_names}) == 1:
        preps = [L.local_loss_prepare(gen, pred_points, gt_points, gt_focal, params[n]["level"],
                                      params[n].get("align_resolution", 32), params[n].get("num_patches", 16))
                 for n in local_names]
        src, tgt, w_lr = (torch.cat([p[0][i] for p in preps]) for i in range(3))
        scale_all, shift_all = align_points_scale_xyz_shift(src, tgt, w_lr, trunc=solver_key(local_names[0])[0])
        off = 0
        for name, (inputs, ctx) in zip(local_names, preps):
            rows = inputs[0].shape[0]
            local_results[name] = L.local_loss_finish(ctx, scale_all[off:off + rows], shift_all[off:off + rows],
                                                      gt_metric_scale, beta=params[name].get("beta", 0.0),
                                                      sparsity_aware=params[name].get("sparsity_aware", False))
            off += rows

    for name, spec in entries.items():
        fn = spec["function"]
        w = weights[name]
        if fn == "affine_invariant_global_loss":
            continue
        if fn == "affine_invariant_local_loss":
            if name in local_results:
                loss_b, misc = local_results[name]
            else:
                loss_b, misc = L.affine_invariant_local_loss(gen, pred_points, gt_points, gt_focal,
                                                             gt_metric_scale, **params[name])
        elif fn == "normal_loss":
            loss_b, misc = L.normal_loss(pred_points, gt_points)
        elif fn == "edge_loss":
            loss_b, misc = L.edge_loss(pred_points, gt_points)
        elif fn == "normal_map_loss":
            if output.get("normal") is None:
                continue
            gt_normal = torch.where(batch["normal_mask"][..., None], batch["normal"], torch.inf)
            loss_b, misc = L.normal_map_loss(output["normal"], gt_normal)
        elif fn == "mask_bce_loss":
            if output.get("mask_logit") is not None:
                # logit-space BCE: its gradient stays p - y where the sigmoid saturates
                loss_b, misc = L.mask_bce_logit_loss(output["mask_logit"], gt_mask_fin, batch["depth_mask_inf"])
            else:
                loss_b, misc = L.mask_bce_loss(output["mask"], gt_mask_fin, batch["depth_mask_inf"])
        elif fn == "mask_l2_loss":
            loss_b, misc = L.mask_l2_loss(output["mask"], gt_mask_fin, batch["depth_mask_inf"])
        elif fn == "metric_scale_loss":
            if output.get("metric_scale") is None or gt_metric_scale is None:
                continue
            loss_b, misc = L.metric_scale_loss(output["metric_scale"], gt_metric_scale)
            w = w * batch["is_metric"].float()
        else:
            raise ValueError(f"Undefined loss function: {fn}")
        add(name, loss_b, misc, w)

    metrics["monitoring.std"] = L.monitoring(pred_points)["std"] if pred_points is not None else total * 0
    metrics["total"] = total
    return total, metrics


def make_grad_step(module: nn.Module, loss_config: Dict[str, Dict], label_types: Sequence[str], num_tokens: int,
                   dtype: torch.dtype = torch.bfloat16, ranks=None) -> Callable:
    """``grad_step(batch, gen) -> (grads, metrics)``: forward in ``dtype``,
    losses, backward; no update. ``grads`` holds every trainable parameter's
    gradient by state-dict name (zeros where the loss does not reach it).
    With ``ranks`` (a multi-process ``parallel.distributed.Parallel``) the
    batch is this rank's share, and 'monitoring.std' is taken over every
    rank's (the one metric a mean over the ranks would not give)."""

    def trainable():
        # read anew each time: a sharded (FSDP) module swaps a unit's parameters
        # for gathered ones while the unit is gathered, and back after
        return [(n, p) for n, p in module.named_parameters() if p.requires_grad]

    def grad_step(batch: Dict[str, torch.Tensor], gen: torch.Generator):
        for _, p in trainable():
            p.grad = None
        output = module(batch["image"], num_tokens, dtype)
        total, metrics = compute_losses(gen, output, batch, loss_config, label_types)
        if ranks is not None and ranks.mesh is not None and output.get("points") is not None:
            metrics["monitoring.std"] = ranks.std(output["points"])
        total.backward()
        params = trainable()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in params}
        for _, p in params:
            p.grad = None
        return grads, {k: v.detach() for k, v in metrics.items()}

    return grad_step


def make_apply_step(tx: Optimizer, ema_decay: float = 0.999) -> Callable:
    """``apply_step(state, grads) -> (state, grads_ok)``: when every gradient
    is finite, one optimizer update (clip, AdamW, schedule count + 1); else
    the parameters and the optimizer state stay as they are. Then the fp32
    EMA ``e * decay + p * (1 - decay)`` and the step count, either way."""

    @torch.no_grad()
    def apply_step(state: TrainState, grads: Grads):
        # the count over the whole gradients: under FSDP every rank's shards, so all agree
        grads_ok = bool(whole(sum((~torch.isfinite(g)).sum() for g in grads.values())) == 0)
        if grads_ok:
            tx.step(grads)
        if state.ema_params is not None:
            named = dict(state.module.named_parameters())
            for name, e in state.ema_params.items():
                e.mul_(ema_decay).add_(named[name].float(), alpha=1.0 - ema_decay)
        state.step += 1
        return state, grads_ok

    return apply_step


def accumulate_grads(acc: Grads, grads: Grads) -> Grads:
    """Running sum of gradient dicts."""
    return {k: acc[k] + grads[k] for k in acc}


def scale_grads(grads: Grads, denom: float) -> Grads:
    """Divide a gradient dict by the micro-batch count (sum -> mean)."""
    return {k: g / denom for k, g in grads.items()}


def make_train_step(module: nn.Module, tx: Optimizer, loss_config: Dict[str, Dict], label_types: Sequence[str],
                    num_tokens: int, ema_decay: float = 0.999, dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``train_step(state, batch, gen) -> (state, metrics)``: grad step plus
    apply step; ``metrics['grads_ok']`` is 1.0 when the update was applied."""
    grad_step = make_grad_step(module, loss_config, label_types, num_tokens, dtype)
    apply_step = make_apply_step(tx, ema_decay)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], gen: torch.Generator):
        grads, metrics = grad_step(batch, gen)
        state, grads_ok = apply_step(state, grads)
        metrics["grads_ok"] = torch.tensor(float(grads_ok))
        return state, metrics

    return train_step
