"""MoGe training losses (port of moge_tpu/train/losses.py).

Affine-invariant global and local point losses supervised through the exact
L1 alignment solvers (``ops/alignment.py``, kernel K4 on the card), the
quad-normal and edge direction losses, and the mask, metric-scale and
normal-map losses. Every loss returns a per-instance (B,) loss and a dict of
scalar metric tensors; nothing syncs with the host except the anchor-weight
offsets, which become slice bounds.

Random draws (the anchor-weight test offsets and the per-instance anchor
choice) all go through ``draw`` with an explicit ``torch.Generator``; tests
replace it to feed both packages the same draws.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.alignment import align_points_scale_xyz_shift, align_points_scale_z_shift
from ..ops.geometry import angle_diff_vec3, harmonic_mean, masked_nearest_resize, weighted_mean

Metrics = Dict[str, torch.Tensor]


def draw(gen: torch.Generator, what: str, arg, size) -> torch.Tensor:
    """Every random draw of the losses, on the generator's device.
    ``what='offsets'``: integers uniform in [-arg, arg] of shape ``size``;
    ``what='anchors'``: ``size`` indices per row drawn with replacement from
    the row probabilities ``arg`` (rows, n)."""
    if what == "offsets":
        return torch.randint(-arg, arg + 1, size, generator=gen, device=gen.device)
    if what == "anchors":
        return torch.multinomial(arg.to(gen.device), size, replacement=True, generator=gen)
    raise ValueError(f"unknown draw {what!r}")


def _smooth(err: torch.Tensor, beta: float = 0.0) -> torch.Tensor:
    if beta == 0:
        return err
    return torch.where(err < beta, 0.5 * err.square() / beta, err - 0.5 * beta)


def _finite_points(gt_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask of finite points, points with the others set to 1)."""
    mask = torch.isfinite(gt_points).all(-1)
    return mask, torch.where(mask[..., None], gt_points, 1.0)


def affine_invariant_global_loss(pred_points: torch.Tensor, gt_points: torch.Tensor, align_resolution: int = 64,
                                 beta: float = 0.0, trunc: float = 1.0, sparsity_aware: bool = False):
    """Returns (loss (B,), metrics, detached alignment scale (B,))."""
    mask, gt_points = _finite_points(gt_points)
    pred_lr, gt_lr, lr_mask = masked_nearest_resize(pred_points, gt_points, mask=mask,
                                                    size=(align_resolution, align_resolution))
    b = pred_lr.shape[0]
    w = lr_mask.reshape(b, -1) / gt_lr[..., 2].reshape(b, -1).clamp_min(1e-2)
    scale, shift = align_points_scale_z_shift(pred_lr.reshape(b, -1, 3), gt_lr.reshape(b, -1, 3), w, trunc=trunc)
    valid = scale > 0
    scale = torch.where(valid, scale, 0.0)
    shift = torch.where(valid[..., None], shift, 0.0)

    pred_aligned = scale[..., None, None, None] * pred_points + shift[..., None, None, :]
    weight = (valid[..., None, None] & mask).to(pred_points.dtype) / gt_points[..., 2].clamp_min(1e-5)
    weight = torch.minimum(weight, 10.0 * weighted_mean(weight, mask, dim=(-2, -1), keepdim=True))
    loss = _smooth((pred_aligned - gt_points).abs() * weight[..., None], beta=beta).mean(dim=(-3, -2, -1))
    if sparsity_aware:
        sparsity = mask.float().mean(dim=(-2, -1)) / lr_mask.float().mean(dim=(-2, -1)).clamp_min(1e-7)
        loss = loss / (sparsity + 1e-7)

    err = torch.linalg.vector_norm(pred_aligned.detach() - gt_points, dim=-1) / gt_points[..., 2]
    misc = {"truncated_error": weighted_mean(err.clamp_max(1.0), mask),
            "delta": weighted_mean((err < 1).float(), mask)}
    return loss, misc, scale.detach()


def compute_anchor_sampling_weight(gen: torch.Generator, points: torch.Tensor, mask: torch.Tensor, radius_2d: int,
                                   radius_3d: torch.Tensor, num_test: int = 64,
                                   form: Optional[str] = None) -> torch.Tensor:
    """Importance weights balancing fine structures: a Monte-Carlo estimate of
    each pixel's local 3D-neighbour density from ``num_test`` offsets in the
    ``radius_2d`` box; weight = 1 / count, normalised per image.

    ``form='shift'`` (the JAX package's default) draws each offset once and
    applies it to every pixel (one shifted slice per test); ``form='gather'``
    draws an independent offset per (pixel, test), as the reference does.
    Both give every pixel the same marginal distribution. With no ``form``,
    ``MOGE_ANCHOR_WEIGHT_IMPL`` chooses as in the JAX package: ``gather``
    selects the gather form, anything else the shift form."""
    if form is None:
        form = "gather" if os.environ.get("MOGE_ANCHOR_WEIGHT_IMPL", "shift") == "gather" else "shift"
    if form == "gather":
        return _anchor_sampling_weight_gather(gen, points, mask, radius_2d, radius_3d, num_test)
    if form != "shift":
        raise ValueError(f"unknown anchor-weight form {form!r}")
    height, width = points.shape[-3:-1]
    batch_shape = points.shape[:-3]
    pts = points.reshape(-1, height, width, 3)
    msk = mask.reshape(-1, height, width)
    r = radius_2d
    di = draw(gen, "offsets", r, (num_test,)).tolist()
    dj = draw(gen, "offsets", r, (num_test,)).tolist()
    # pad the mask with False: covers both out-of-bounds tests and invalid pixels
    pts_p = F.pad(pts, (0, 0, r, r, r, r))
    msk_p = F.pad(msk, (r, r, r, r))
    r3 = radius_3d.reshape(-1, height, width)
    count = torch.zeros(msk.shape, dtype=torch.float32, device=points.device)
    for i, j in zip(di, dj):
        tp = pts_p[:, r + i:r + i + height, r + j:r + j + width]
        tm = msk_p[:, r + i:r + i + height, r + j:r + j + width]
        count += ((torch.linalg.vector_norm(tp - pts, dim=-1) <= r3) & tm).float()
    weight = torch.where(msk, 1.0 / count.clamp_min(1.0), 0.0)
    weight = weight / (weight.sum(dim=(-2, -1), keepdim=True) + 1e-7)
    return weight.reshape(*batch_shape, height, width)


def _anchor_sampling_weight_gather(gen, points, mask, radius_2d, radius_3d, num_test):
    """The per-(pixel, test) offset form: ``num_test`` gathers over the map."""
    height, width = points.shape[-3:-1]
    dev = points.device
    test_di = draw(gen, "offsets", radius_2d, (height, width, num_test)).to(dev)
    test_dj = draw(gen, "offsets", radius_2d, (height, width, num_test)).to(dev)
    ti = torch.arange(height, device=dev)[:, None, None] + test_di
    tj = torch.arange(width, device=dev)[None, :, None] + test_dj
    in_bounds = (ti >= 0) & (ti < height) & (tj >= 0) & (tj < width)
    ti, tj = ti.clamp(0, height - 1), tj.clamp(0, width - 1)
    test_mask = in_bounds & mask[..., ti, tj]
    test_dist = torch.linalg.vector_norm(points[..., ti, tj, :] - points[..., None, :], dim=-1)
    near = (test_dist <= radius_3d[..., None]) & test_mask
    weight = torch.where(mask, 1.0 / near.float().sum(-1).clamp_min(1.0), 0.0)
    return weight / (weight.sum(dim=(-2, -1), keepdim=True) + 1e-7)


def local_loss_prepare(gen: torch.Generator, pred_points: torch.Tensor, gt_points: torch.Tensor,
                       focal: torch.Tensor, level: int, align_resolution: int = 32, num_patches: int = 16,
                       anchor_weight_form: Optional[str] = None):
    """Patch sampling and extraction, and the low-resolution solver inputs of
    the local loss. Returns ``((src (P, R*R, 3), tgt (P, R*R, 3), w (P, R*R)),
    ctx)``; ``ctx`` carries the full-resolution patches for
    ``local_loss_finish``. Several levels with one ``align_resolution`` can
    share one solver call by concatenating their inputs."""
    height, width = pred_points.shape[-3], pred_points.shape[-2]
    batch_size = pred_points.shape[0]
    dev = pred_points.device
    gt_mask, gt_points = _finite_points(gt_points)

    radius_2d = math.ceil(0.5 / level * (height ** 2 + width ** 2) ** 0.5)
    radius_3d = 0.5 / level / focal[..., None, None] * gt_points[..., 2]
    anchor_weights = compute_anchor_sampling_weight(gen, gt_points, gt_mask, radius_2d, radius_3d, 64,
                                                    anchor_weight_form)

    # every instance draws num_patches anchors from its own distribution
    hw = height * width
    p = (anchor_weights * gt_mask).reshape(batch_size, hw)
    p_sum = p.sum(-1, keepdim=True)
    p = torch.where(p_sum > 0, p / p_sum.clamp_min(1e-12), 1.0 / hw)
    rem = draw(gen, "anchors", p, num_patches).to(dev).reshape(-1)           # (B * num_patches,)
    patch_batch_idx = torch.arange(batch_size, device=dev).repeat_interleave(num_patches)
    anchor_i, anchor_j = rem // width, rem % width

    offs = torch.arange(-radius_2d, radius_2d + 1, device=dev)
    patch_i = offs[None, :, None] + anchor_i[:, None, None]
    patch_j = offs[None, None, :] + anchor_j[:, None, None]
    in_bounds = (patch_i >= 0) & (patch_i < height) & (patch_j >= 0) & (patch_j < width)
    patch_i, patch_j = patch_i.clamp(0, height - 1), patch_j.clamp(0, width - 1)

    gt_anchor_pts = gt_points[patch_batch_idx, anchor_i, anchor_j]                 # (P, 3)
    gt_patch_radius_3d = 0.5 / level / focal[patch_batch_idx] * gt_anchor_pts[:, 2]
    b_idx = patch_batch_idx[:, None, None]
    gt_patch_points = gt_points[b_idx, patch_i, patch_j]                          # (P, k, k, 3)
    gt_patch_dist = torch.linalg.vector_norm(gt_patch_points - gt_anchor_pts[:, None, None, :], dim=-1)
    patch_mask = in_bounds & gt_mask[b_idx, patch_i, patch_j] & (gt_patch_dist <= gt_patch_radius_3d[:, None, None])
    patch_nonempty = patch_mask.sum(dim=(-2, -1)) >= 32  # minimum points per patch

    pred_patch_points = pred_points[b_idx, patch_i, patch_j]
    pred_lr, gt_lr, lr_mask = masked_nearest_resize(pred_patch_points, gt_patch_points, mask=patch_mask,
                                                    size=(align_resolution, align_resolution))
    n_patches = pred_lr.shape[0]
    w_lr = lr_mask.reshape(n_patches, -1) / (gt_patch_radius_3d[:, None] + 1e-7)
    ctx = dict(pred_patch_points=pred_patch_points, gt_patch_points=gt_patch_points, patch_mask=patch_mask,
               patch_nonempty=patch_nonempty, gt_patch_radius_3d=gt_patch_radius_3d,
               patch_batch_idx=patch_batch_idx, lr_mask=lr_mask,
               gt_mean=harmonic_mean(gt_points[..., 2], gt_mask, dim=(-2, -1)),
               batch_size=batch_size, num_patches=num_patches)
    return (pred_lr.reshape(n_patches, -1, 3), gt_lr.reshape(n_patches, -1, 3), w_lr), ctx


def local_loss_finish(ctx: Dict, local_scale: torch.Tensor, local_shift: torch.Tensor,
                      global_scale: Optional[torch.Tensor], beta: float = 0.0,
                      sparsity_aware: bool = False) -> Tuple[torch.Tensor, Metrics]:
    """Patch validation, the alignment applied, and the loss reduction."""
    pred_patch_points, gt_patch_points = ctx["pred_patch_points"], ctx["gt_patch_points"]
    patch_batch_idx = ctx["patch_batch_idx"]
    if global_scale is not None:
        g = global_scale[patch_batch_idx]
        scale_differ = local_scale / g.clamp_min(1e-12)
        patch_valid = (scale_differ > 0.1) & (scale_differ < 10.0) & (g > 0)
    else:
        patch_valid = local_scale > 0
    patch_valid = patch_valid & ctx["patch_nonempty"]
    local_scale = torch.where(patch_valid, local_scale, 0.0)
    local_shift = torch.where(patch_valid[:, None], local_shift, 0.0)
    patch_mask = ctx["patch_mask"] & patch_valid[:, None, None]

    pred_aligned = local_scale[:, None, None, None] * pred_patch_points + local_shift[:, None, None, :]
    patch_weight = patch_mask.float() / torch.maximum(gt_patch_points[..., 2],
                                                      0.1 * ctx["gt_mean"][patch_batch_idx, None, None])
    per_patch = _smooth((pred_aligned - gt_patch_points).abs() * patch_weight[..., None], beta=beta)
    per_patch = per_patch.mean(dim=(-3, -2, -1))
    if sparsity_aware:
        sparsity = patch_mask.float().mean(dim=(-2, -1)) / ctx["lr_mask"].float().mean(dim=(-2, -1)).clamp_min(1e-7)
        per_patch = per_patch / (sparsity + 1e-7)
    per_patch = torch.where(patch_valid, per_patch, 0.0)
    # patches are grouped by instance, num_patches each
    loss = per_patch.reshape(ctx["batch_size"], ctx["num_patches"]).sum(-1) / ctx["num_patches"]

    err = torch.linalg.vector_norm(pred_aligned.detach() - gt_patch_points, dim=-1) / (
        ctx["gt_patch_radius_3d"][..., None, None] + 1e-12)
    misc = {"truncated_error": weighted_mean(err.clamp_max(1.0), patch_mask),
            "delta": weighted_mean((err < 1).float(), patch_mask)}
    return loss, misc


def affine_invariant_local_loss(gen: torch.Generator, pred_points: torch.Tensor, gt_points: torch.Tensor,
                                focal: torch.Tensor, global_scale: Optional[torch.Tensor], level: int,
                                align_resolution: int = 32, num_patches: int = 16, beta: float = 0.0,
                                trunc: float = 1.0, sparsity_aware: bool = False,
                                anchor_weight_form: Optional[str] = None) -> Tuple[torch.Tensor, Metrics]:
    """Prepare -> scale/xyz-shift solve -> finish. Returns (loss (B,), metrics)."""
    (src, tgt, w_lr), ctx = local_loss_prepare(gen, pred_points, gt_points, focal, level, align_resolution,
                                               num_patches, anchor_weight_form)
    local_scale, local_shift = align_points_scale_xyz_shift(src, tgt, w_lr, trunc=trunc)
    return local_loss_finish(ctx, local_scale, local_shift, global_scale, beta=beta, sparsity_aware=sparsity_aware)


def normal_loss(points: torch.Tensor, gt_points: torch.Tensor) -> Tuple[torch.Tensor, Metrics]:
    """Quad cross-product normal agreement, per instance."""
    mask, gt_points = _finite_points(gt_points)

    def quads(p):
        lu, ru, ld, rd = p[..., :-1, :-1, :], p[..., :-1, 1:, :], p[..., 1:, :-1, :], p[..., 1:, 1:, :]
        cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)  # noqa: E731
        return (cross(ru - rd, ld - rd), cross(lu - ru, rd - ru), cross(ld - lu, ru - lu), cross(rd - ld, lu - ld))

    m_lu, m_ru, m_ld, m_rd = mask[..., :-1, :-1], mask[..., :-1, 1:], mask[..., 1:, :-1], mask[..., 1:, 1:]
    masks = (m_ru & m_ld & m_rd, m_lu & m_rd & m_ru, m_ld & m_ru & m_lu, m_rd & m_lu & m_ld)
    lo, hi, beta = math.radians(1), math.radians(90), math.radians(3)
    loss = 0.0
    for p, g, m in zip(quads(points), quads(gt_points), masks):
        loss = loss + m * _smooth(angle_diff_vec3(p, g).clamp(lo, hi), beta=beta)
    return loss.mean(dim=(-2, -1)) / (4 * max(points.shape[-3:-1])), {}


def edge_loss(points: torch.Tensor, gt_points: torch.Tensor) -> Tuple[torch.Tensor, Metrics]:
    """dx/dy direction agreement, per instance."""
    mask, gt_points = _finite_points(gt_points)
    dx = points[..., :-1, :, :] - points[..., 1:, :, :]
    dy = points[..., :, :-1, :] - points[..., :, 1:, :]
    gt_dx = gt_points[..., :-1, :, :] - gt_points[..., 1:, :, :]
    gt_dy = gt_points[..., :, :-1, :] - gt_points[..., :, 1:, :]
    mask_dx = mask[..., :-1, :] & mask[..., 1:, :]
    mask_dy = mask[..., :, :-1] & mask[..., :, 1:]
    lo, hi, beta = math.radians(0.1), math.radians(90), math.radians(3)
    loss_dx = mask_dx * _smooth(angle_diff_vec3(dx, gt_dx).clamp(lo, hi), beta=beta)
    loss_dy = mask_dy * _smooth(angle_diff_vec3(dy, gt_dy).clamp(lo, hi), beta=beta)
    loss = (loss_dx.mean(dim=(-2, -1)) + loss_dy.mean(dim=(-2, -1))) / (2 * max(points.shape[-3:-1]))
    return loss, {}


def mask_l2_loss(pred_mask: torch.Tensor, gt_mask_pos: torch.Tensor, gt_mask_neg: torch.Tensor):
    loss = gt_mask_neg * pred_mask.square() + gt_mask_pos * (1 - pred_mask).square()
    return loss.mean(dim=(-2, -1)), {}


def _clamped_log(p: torch.Tensor) -> torch.Tensor:
    """max(log p, -100), with the log's input guarded so its gradient is finite at p = 0."""
    return torch.where(p > 0, torch.log(torch.where(p > 0, p, 1.0)).clamp_min(-100.0), -100.0)


def mask_bce_loss(pred_mask_prob: torch.Tensor, gt_mask_pos: torch.Tensor, gt_mask_neg: torch.Tensor):
    """BCE on the probability (torch's BCE semantics: log clamped at -100)."""
    log_p, log_1p = _clamped_log(pred_mask_prob), _clamped_log(1.0 - pred_mask_prob)
    bce = -(gt_mask_pos * log_p + (1.0 - gt_mask_pos.to(log_p.dtype)) * log_1p)
    return ((gt_mask_pos | gt_mask_neg) * bce).mean(dim=(-2, -1)), {}


def mask_bce_logit_loss(mask_logit: torch.Tensor, gt_mask_pos: torch.Tensor, gt_mask_neg: torch.Tensor):
    """BCE in logit space, in fp32: the gradient w.r.t. the logit is
    sigmoid(z) - y at every finite logit, also where the sigmoid saturates."""
    z = mask_logit.float()
    log_p, log_1p = F.logsigmoid(z).clamp_min(-100.0), F.logsigmoid(-z).clamp_min(-100.0)
    bce = -(gt_mask_pos * log_p + (1.0 - gt_mask_pos.to(log_p.dtype)) * log_1p)
    return ((gt_mask_pos | gt_mask_neg) * bce).mean(dim=(-2, -1)), {}


def metric_scale_loss(scale_pred: torch.Tensor, scale_gt: torch.Tensor):
    """Log-MSE on the metric scale; instances without a positive target count 0."""
    valid = scale_gt > 0
    sq = (torch.log(scale_pred.clamp_min(1e-12)) - torch.where(valid, torch.log(scale_gt.clamp_min(1e-12)), 0.0))
    return torch.where(valid, sq.square(), 0.0), {}


def normal_map_loss(pred_normal: torch.Tensor, gt_normal: torch.Tensor):
    """Squared angle between normal maps over the finite targets."""
    mask, gt_normal = _finite_points(gt_normal)
    return (mask * angle_diff_vec3(pred_normal, gt_normal).square()).mean(dim=(-2, -1)), {}


def monitoring(points: torch.Tensor) -> Metrics:
    return {"std": points.std(correction=0)}
