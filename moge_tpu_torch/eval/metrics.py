"""Benchmark evaluation metrics (port of moge_tpu/eval/metrics.py; reference
moge/test/metrics.py:25-342).

Unified `compute_metrics(pred, gt)` keyed on the prediction's invariance
class: metric / scale-invariant / affine-invariant depth & points, affine
disparity, local (segment) points, FOV MAE, multi-threshold boundary F1.

Host-side orchestration runs in numpy (eval is per-sample and ragged); the
exact-L1 alignment solves run through the port's ``ops.alignment`` on the
``device`` given (the card by default). The JAX package pads every solve to
4096 entries of weight 0 so that XLA compiles each once; that padding is
not carried over: zero-weight entries change neither the weighted-median
search nor the anchors (masked by w > 0), so the solves take the unpadded
arrays.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, Tuple, Union

import numpy as np
import torch

from ..ops import alignment as al
from ..utils.geometry_numpy import intrinsics_to_fov_numpy, masked_nearest_resize_numpy
from ..utils.tools import key_average, span

__all__ = ["compute_metrics", "boundary_f1", "SOLVES"]

# device type -> alignment solves run there (reset it to count a stretch of work)
SOLVES: Counter = Counter()


def rel_depth(pred, gt, eps: float = 1e-6) -> float:
    return float(np.mean(np.abs(pred - gt) / (gt + eps)))


def delta1_depth(pred, gt) -> float:
    return float(np.mean(np.maximum(gt / pred, pred / gt) < 1.25))


def rel_point(pred, gt, eps: float = 1e-6) -> float:
    return float(np.mean(np.linalg.norm(pred - gt, axis=-1) / (np.linalg.norm(gt, axis=-1) + eps)))


def delta1_point(pred, gt) -> float:
    dist_pred = np.linalg.norm(pred, axis=-1)
    dist_gt = np.linalg.norm(gt, axis=-1)
    dist_err = np.linalg.norm(pred - gt, axis=-1)
    return float(np.mean(dist_err < 0.25 * np.minimum(dist_gt, dist_pred)))


def rel_point_local(pred, gt, diameter) -> float:
    return float(np.mean(np.linalg.norm(pred - gt, axis=-1) / diameter))


def delta1_point_local(pred, gt, diameter) -> float:
    return float(np.mean(np.linalg.norm(pred - gt, axis=-1) < 0.25 * diameter))


def _sliding_window_2d(x: np.ndarray, k: int) -> np.ndarray:
    """(H, W) -> (H-k+1, W-k+1, k, k) view."""
    from numpy.lib.stride_tricks import sliding_window_view

    return sliding_window_view(x, (k, k))


def boundary_f1(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray, radius: int = 1) -> float:
    """Multi-threshold boundary F1 (reference metrics.py:63-92)."""
    k = 2 * radius + 1
    nx, ny = np.meshgrid(np.linspace(-radius, radius, k), np.linspace(-radius, radius, k), indexing="xy")
    neighbor_mask = (nx ** 2 + ny ** 2) <= radius ** 2 + 1e-5

    pred_w = _sliding_window_2d(pred, k)
    gt_w = _sliding_window_2d(gt, k)
    mask_w = neighbor_mask & _sliding_window_2d(mask, k)

    center_pred = pred[radius:-radius, radius:-radius, None, None]
    center_gt = gt[radius:-radius, radius:-radius, None, None]
    pred_rel = pred_w / center_pred
    gt_rel = gt_w / center_gt
    valid = mask[radius:-radius, radius:-radius, None, None] & mask_w

    t_list = np.linspace(0.05, 0.25, 10)
    f1_list = []
    for t in t_list:
        pred_label = pred_rel > 1 + t
        gt_label = gt_rel > 1 + t
        tp = float((pred_label & gt_label & valid).sum())
        # NOTE: mirrors the reference exactly, including its swapped
        # precision/recall denominators (metrics.py:86-87).
        precision = tp / max(float((gt_label & valid).sum()), 1e-12)
        recall = tp / max(float((pred_label & valid).sum()), 1e-12)
        f1_list.append(2 * precision * recall / max(precision + recall, 1e-12))
    return float(sum(w * f for w, f in zip(t_list, f1_list)) / t_list.sum())


def _solve(fn: Callable, device: torch.device, *arrays: np.ndarray, dtype=np.float32):
    """``fn`` on the arrays as ``dtype`` tensors on ``device``; the result
    back on the host as floats (0-d) or numpy arrays. Counted in ``SOLVES``;
    the span ``moge.eval.solve`` (``utils.tools.span``)."""
    with span("moge.eval.solve", device=True):
        out = fn(*(torch.as_tensor(np.asarray(a, dtype), device=device) for a in arrays))
        SOLVES[device.type] += 1
        return tuple(_host(o) for o in out) if isinstance(out, tuple) else _host(out)


def _host(t: torch.Tensor):
    return float(t) if t.dim() == 0 else t.cpu().numpy()


def _align_depth_scale(pred_m, gt_m, device) -> float:
    return _solve(al.align_depth_scale, device, pred_m, gt_m, 1.0 / gt_m)


def _align_depth_affine(pred_m, gt_m, device) -> Tuple[float, float]:
    return _solve(al.align_depth_affine, device, pred_m, gt_m, 1.0 / gt_m)


def _align_points_scale(pred_m, gt_m, device) -> float:
    return _solve(al.align_points_scale, device, pred_m, gt_m, 1.0 / np.linalg.norm(gt_m, axis=-1))


def _align_points_scale_xyz_shift(pred_m, gt_m, w_vals, device) -> Tuple[float, np.ndarray]:
    return _solve(al.align_points_scale_xyz_shift, device, pred_m, gt_m, w_vals)


def _align_points_xyz_shift(pred_m, gt_m, device) -> np.ndarray:
    return _solve(al.align_points_xyz_shift, device, pred_m, gt_m, 1.0 / np.linalg.norm(gt_m, axis=-1))


def compute_metrics(
    pred: Dict[str, np.ndarray], gt: Dict[str, Any], vis: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[Dict[str, Dict[str, float]], Dict[str, np.ndarray]]:
    """Unified metric computation (reference metrics.py:95-342), the
    alignment solves on ``device``.

    pred keys: depth_metric / depth_scale_invariant / depth_affine_invariant /
    disparity_affine_invariant / points_metric / points_scale_invariant /
    points_affine_invariant / intrinsics.
    gt keys: depth, depth_mask, points, intrinsics, is_metric,
    has_sharp_boundary, optional segmentation_mask + segmentation_labels.
    """
    device = torch.device(device)
    metrics: Dict[str, Dict[str, float]] = {}
    misc: Dict[str, np.ndarray] = {}

    mask = np.asarray(gt["depth_mask"])
    gt_depth = np.asarray(gt["depth"])
    gt_points = np.asarray(gt["points"])

    lr_mask, lr_index = masked_nearest_resize_numpy(mask=mask, size=(64, 64), return_index=True)

    only_depth = not any("point" in k for k in pred)
    pred_depth_aligned = None
    pred_points_aligned = None

    # ---- metric depth ----
    if "depth_metric" in pred and gt["is_metric"]:
        pred_depth = np.asarray(pred["depth_metric"])
        metrics["depth_metric"] = {
            "rel": rel_depth(pred_depth[mask], gt_depth[mask]),
            "delta1": delta1_depth(pred_depth[mask], gt_depth[mask]),
        }
        pred_depth_aligned = pred_depth

    # ---- scale-invariant depth ----
    src = pred.get("depth_scale_invariant", pred.get("depth_metric"))
    if src is not None:
        pred_depth = np.asarray(src)
        pm, gm = pred_depth[lr_index][lr_mask], gt_depth[lr_index][lr_mask]
        scale = _align_depth_scale(pm, gm, device)
        pred_depth = pred_depth * scale
        metrics["depth_scale_invariant"] = {
            "rel": rel_depth(pred_depth[mask], gt_depth[mask]),
            "delta1": delta1_depth(pred_depth[mask], gt_depth[mask]),
        }
        if pred_depth_aligned is None:
            pred_depth_aligned = pred_depth

    # ---- affine-invariant depth ----
    src = pred.get("depth_affine_invariant", pred.get("depth_scale_invariant", pred.get("depth_metric")))
    if src is not None:
        pred_depth = np.asarray(src)
        pm, gm = pred_depth[lr_index][lr_mask], gt_depth[lr_index][lr_mask]
        scale, shift = _align_depth_affine(pm, gm, device)
        pred_depth = pred_depth * scale + shift
        metrics["depth_affine_invariant"] = {
            "rel": rel_depth(pred_depth[mask], gt_depth[mask]),
            "delta1": delta1_depth(pred_depth[mask], gt_depth[mask]),
        }
        if pred_depth_aligned is None:
            pred_depth_aligned = pred_depth

    # ---- affine-invariant disparity ----
    if "disparity_affine_invariant" in pred:
        pred_disp = np.asarray(pred["disparity_affine_invariant"])
    elif "depth_scale_invariant" in pred:
        pred_disp = 1.0 / np.asarray(pred["depth_scale_invariant"])
    elif "depth_metric" in pred:
        pred_disp = 1.0 / np.asarray(pred["depth_metric"])
    else:
        pred_disp = None
    if pred_disp is not None:
        # fp64: in fp32 the 2x2 normal equations lose ~4 digits to
        # cancellation (the JAX package's fp32 answer is 1-4e-5 off this one)
        a, b = _solve(al.align_affine_lstsq, device, pred_disp[mask], 1.0 / gt_depth[mask], dtype=np.float64)
        disp_aligned = pred_disp * a + b
        pred_depth = 1.0 / np.maximum(disp_aligned, 1.0 / gt_depth[mask].max())
        metrics["disparity_affine_invariant"] = {
            "rel": rel_depth(pred_depth[mask], gt_depth[mask]),
            "delta1": delta1_depth(pred_depth[mask], gt_depth[mask]),
        }
        if pred_depth_aligned is None:
            pred_depth_aligned = 1.0 / np.maximum(disp_aligned, 1e-6)

    # ---- metric points ----
    if "points_metric" in pred and gt["is_metric"]:
        pred_points = np.asarray(pred["points_metric"])
        pm, gm = pred_points[lr_index][lr_mask], gt_points[lr_index][lr_mask]
        shift = _align_points_xyz_shift(pm, gm, device)
        pred_points = pred_points + shift
        metrics["points_metric"] = {
            "rel": rel_point(pred_points[mask], gt_points[mask]),
            "delta1": delta1_point(pred_points[mask], gt_points[mask]),
        }
        pred_points_aligned = np.asarray(pred["points_metric"])

    # ---- scale-invariant points ----
    src = pred.get("points_scale_invariant", pred.get("points_metric"))
    if src is not None:
        pred_points = np.asarray(src)
        pm, gm = pred_points[lr_index][lr_mask], gt_points[lr_index][lr_mask]
        scale = _align_points_scale(pm, gm, device)
        pred_points_s = pred_points * scale
        metrics["points_scale_invariant"] = {
            "rel": rel_point(pred_points_s[mask], gt_points[mask]),
            "delta1": delta1_point(pred_points_s[mask], gt_points[mask]),
        }
        if vis and pred_points_aligned is None:
            pred_points_aligned = pred_points_s

    # ---- affine-invariant points ----
    src = pred.get(
        "points_affine_invariant", pred.get("points_scale_invariant", pred.get("points_metric"))
    )
    if src is not None:
        pred_points = np.asarray(src)
        pm, gm = pred_points[lr_index][lr_mask], gt_points[lr_index][lr_mask]
        scale, shift = _align_points_scale_xyz_shift(pm, gm, 1.0 / np.linalg.norm(gm, axis=-1), device)
        pred_points_a = pred_points * scale + shift
        metrics["points_affine_invariant"] = {
            "rel": rel_point(pred_points_a[mask], gt_points[mask]),
            "delta1": delta1_point(pred_points_a[mask], gt_points[mask]),
        }
        if vis and pred_points_aligned is None:
            pred_points_aligned = pred_points_a

    # ---- local (segment) points ----
    if "segmentation_mask" in gt and any("points" in k for k in pred):
        pred_points = np.asarray(next(pred[k] for k in pred if "points" in k))
        seg = np.asarray(gt["segmentation_mask"])
        seg_lr = seg[lr_index]
        local_metrics = []
        for _, seg_id in gt["segmentation_labels"].items():
            valid = (seg == seg_id) & mask
            valid_lr = (seg_lr == seg_id) & lr_mask
            if valid_lr.sum() < 10:
                continue
            pm = pred_points[lr_index][valid_lr]
            gm = gt_points[lr_index][valid_lr]
            gm_full = gt_points[valid]
            diameter = float((gm_full.max(axis=0) - gm_full.min(axis=0)).max())
            scale, shift = _align_points_scale_xyz_shift(
                pm, gm, np.full((len(gm),), 1.0 / diameter, np.float32), device
            )
            pred_seg = pred_points[valid] * scale + shift
            local_metrics.append({
                "rel": rel_point_local(pred_seg, gm_full, diameter),
                "delta1": delta1_point_local(pred_seg, gm_full, diameter),
            })
        if local_metrics:
            metrics["local_points"] = key_average(local_metrics)

    # ---- FOV ----
    if "intrinsics" in pred and "intrinsics" in gt:
        pred_fov_x, _ = intrinsics_to_fov_numpy(np.asarray(pred["intrinsics"]))
        gt_fov_x, _ = intrinsics_to_fov_numpy(np.asarray(gt["intrinsics"]))
        dev = float(np.rad2deg(pred_fov_x - gt_fov_x))
        metrics["fov_x"] = {"mae": abs(dev), "deviation": dev}

    # ---- boundary F1 ----
    if pred_depth_aligned is not None and gt.get("has_sharp_boundary", False):
        metrics["boundary"] = {
            f"radius{r}_f1": boundary_f1(pred_depth_aligned, gt_depth, mask, radius=r)
            for r in (1, 2, 3)
        }

    if vis:
        if pred_points_aligned is not None:
            misc["pred_points"] = pred_points_aligned
        if only_depth and pred_depth_aligned is not None:
            from ..ops.geometry import depth_map_to_point_map

            misc["pred_points"] = depth_map_to_point_map(
                torch.as_tensor(np.asarray(pred_depth_aligned, np.float32), device=device),
                torch.as_tensor(np.asarray(gt["intrinsics"], np.float32), device=device),
            ).cpu().numpy()
        if pred_depth_aligned is not None:
            misc["pred_depth"] = pred_depth_aligned

    return metrics, misc
