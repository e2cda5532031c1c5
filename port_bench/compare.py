"""The comparison that decides ``correct``: each sampled answer of the timed
path against the plain reference run on the same image and weights.

Per image:
  focal_rel        |fx - fx_ref| / fx_ref            the camera solve, intrinsics
  depth_err        sum |d - d_ref| / sum |d_ref|     network, epilogue, shift, metric
                   over the pixels either mask keeps,  scale, mask
                   a masked-out depth counted as 0
  depth_shift_rel  ||d - d_ref - median(d - d_ref)|| network and epilogue, the
                   / ||d_ref|| where both masks keep  solve's shift taken out
  normal_deg       mean angle between the normals    MoGe-2's normal head
                   where both masks keep
(``depth_rel``, ``scale_rel`` and ``mask_flip`` are read too, for the
record.) A cell's number is the largest over its sample; each has its
limit in the cell's file. An answer that never came, has the wrong shape,
or keeps no pixel that the reference keeps, fails. ``check_images`` is the
``check`` of the drivers whose answers are maps of images; a driver whose
answers are of another kind brings its own.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference import fp32, lowp, models
from .weights import draw


def readings(answer: Dict[str, np.ndarray], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers of one image: ``answer`` the program's outputs as host
    arrays, ``ref`` the reference's for the same image (batch of one)."""
    ref = {k: v[0].cpu().numpy().astype(bool if v.dtype == torch.bool else np.float64) for k, v in ref.items()}
    mask = np.asarray(answer["mask"]) > 0.5
    if mask.shape != ref["mask"].shape:
        return {"shape": math.inf}
    both = mask & ref["mask"]
    d, d_ref = np.asarray(answer["depth"], np.float64)[both], ref["depth"][both]
    if not both.any():
        return {"empty": math.inf}
    norm = max(np.linalg.norm(d_ref), 1e-30)
    either = mask | ref["mask"]
    d_all = np.where(mask, np.asarray(answer["depth"], np.float64), 0.0)[either]
    d_ref_all = np.where(ref["mask"], ref["depth"], 0.0)[either]
    out = {"mask_flip": float(np.mean(mask != ref["mask"])),
           "depth_err": float(np.abs(d_all - d_ref_all).sum() / max(np.abs(d_ref_all).sum(), 1e-30)),
           "focal_rel": float(abs(answer["intrinsics"][0, 0] / ref["intrinsics"][0, 0] - 1.0)),
           "depth_rel": float(np.linalg.norm(d - d_ref) / norm),
           "depth_shift_rel": float(np.linalg.norm(d - d_ref - np.median(d - d_ref)) / norm),
           "scale_rel": float(abs(np.median(d / d_ref) - 1.0))}
    if "normal" in ref:
        n, n_ref = np.asarray(answer["normal"], np.float64)[both], ref["normal"][both]
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        cos = np.clip((n * n_ref).sum(-1), -1.0, 1.0)
        out["normal_deg"] = float(np.degrees(np.arccos(cos)).mean())
    return {k: (math.inf if not np.isfinite(v) else v) for k, v in out.items()}


def reference_outputs(config, state_dict, image: torch.Tensor, num_tokens: int, fov_x: Optional[float] = None,
                      rounding: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The reference's outputs for one (H, W, 3) host image, on the weights'
    device, in fp32; ``rounding`` (``tf32``) for a control."""
    device = next(iter(state_dict.values())).device
    with torch.no_grad(), fp32(), lowp.rounding(rounding):
        return models.infer(config["version"], state_dict, config["model_config"], image[None].to(device),
                            num_tokens, fov_x)


def judge(samples: List[Dict[str, float]], limits: Dict[str, float], missing: int = 0) -> Dict[str, Dict]:
    """Each number's largest value over the sample beside its limit, and
    the answers that never came beside 0."""
    checks = {}
    for name, limit in limits.items():
        values = [s[name] for s in samples if name in s]
        bad = not values or any("shape" in s or "empty" in s for s in samples)
        checks[name] = {"value": math.inf if bad else max(values), "limit": limit}
    checks["missing"] = {"value": missing, "limit": 0}
    return checks


def check_images(ctx, found) -> Dict[str, Dict]:
    """``found`` = (samples, missing): each sampled answer against the
    reference on its own image and the same weights (drawn again from the
    seed), in fp32, once the program's state is freed."""
    samples, missing = found
    numbers = []
    if samples:
        config = ctx.config
        sd = draw(config["version"], config["model_config"], config["weights"], ctx.seed, ctx.device)
        for s in samples:
            ref = reference_outputs(config, sd, s["image"], s["num_tokens"], s.get("fov_x"))
            numbers.append(readings(s["answer"], ref))
    return judge(numbers, ctx.workload["limits"], missing)
