"""Camera recovery and post-processing as MoGe publishes them: the focal and
z-shift of an affine point map by a 30-iteration scalar Levenberg-Marquardt
solve on a 64x64 nearest downsample (the focal in closed form per iterate),
then intrinsics, the shifted depth, the re-projected points, the metric
scale and the mask."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1e-12


def view_plane_uv(width: int, height: int, aspect_ratio: Optional[float] = None, device=None) -> torch.Tensor:
    """(H, W, 2) UV spanning +-(w/diag, h/diag) at pixel centres (float64 on the host)."""
    ar = width / height if aspect_ratio is None else aspect_ratio
    sx, sy = ar / (1 + ar ** 2) ** 0.5, 1 / (1 + ar ** 2) ** 0.5
    u = np.linspace(-sx * (width - 1) / width, sx * (width - 1) / width, width)
    v = np.linspace(-sy * (height - 1) / height, sy * (height - 1) / height, height)
    uu, vv = np.meshgrid(u, v, indexing="xy")
    return torch.as_tensor(np.stack([uu, vv], -1), dtype=torch.float32, device=device)


def _nearest(x: torch.Tensor, size) -> torch.Tensor:
    """(N, H, W, C) -> (N, h, w, C), legacy nearest."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="nearest").permute(0, 2, 3, 1)


def _lm(residual, s0: torch.Tensor, iters: int) -> torch.Tensor:
    s, lam = s0, torch.full_like(s0, 1e-3)
    for _ in range(iters):
        r, dr = residual(s, True)
        f_cur = r.square().sum(-1)
        s_new = s - (r * dr).sum(-1) / (dr.square().sum(-1) * (1.0 + lam) + _EPS)
        f_new = residual(s_new, False)[0].square().sum(-1)
        accept = (f_new < f_cur) & torch.isfinite(f_new)
        s = torch.where(accept, s_new, s)
        lam = torch.where(accept, (lam / 3.0).clamp_min(1e-9), (lam * 10.0).clamp_max(1e8))
    return s


def _solve(uv, points, weight, focal, iters):
    xy, z = points[..., :2], points[..., 2]
    sw, w = weight.sqrt()[..., None], weight[..., None]

    def focal_of(proj):
        return (w * proj * uv).sum((-2, -1)), (w * proj.square()).sum((-2, -1))

    def residual(s, jvp):
        zs = (z + s[:, None])[..., None]
        proj = xy / zs
        dproj = -proj / zs
        if focal is not None:
            f = focal[:, None, None]
            return (sw * (f * proj - uv)).flatten(1), (sw * f * dproj).flatten(1) if jvp else None
        num, den = focal_of(proj)
        den_c = den.clamp_min(_EPS)
        f = (num / den_c)[:, None, None]
        r = (sw * (f * proj - uv)).flatten(1)
        if not jvp:
            return r, None
        dnum = (w * dproj * uv).sum((-2, -1))
        dden = 2.0 * (w * proj * dproj).sum((-2, -1))
        df = dnum / den_c - num * torch.where(den > _EPS, dden, 0.0) / den_c.square()
        return r, (sw * (df[:, None, None] * proj + f * dproj)).flatten(1)

    shift = _lm(residual, torch.zeros_like(z[:, 0]), iters)
    if focal is not None:
        return focal, shift
    num, den = focal_of(xy / (z + shift[:, None])[..., None])
    return num / den.clamp_min(_EPS), shift


def recover_focal_shift(points: torch.Tensor, mask: torch.Tensor, focal: Optional[torch.Tensor] = None,
                        size=(64, 64), iters: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """(focal, shift), each (B,), of (B, H, W, 3) points under a (B, H, W) bool
    mask; focal relative to half the image diagonal; (1, 0) where fewer than
    two pixels are valid."""
    b, h, w, _ = points.shape
    uv = view_plane_uv(w, h, device=points.device)
    pts = _nearest(points, size)
    uv_lr = _nearest(uv[None], size)
    wgt = (_nearest(mask.float()[..., None], size)[..., 0] > 0).float()
    valid = wgt.sum((-2, -1))
    pts = torch.where(wgt[..., None] > 0, pts, torch.tensor([0.0, 0.0, 1.0], device=points.device))
    n = size[0] * size[1]
    f, s = _solve(uv_lr.reshape(1, n, 2).expand(b, n, 2), pts.reshape(b, n, 3), wgt.reshape(b, n), focal, iters)
    degenerate = valid < 2
    return torch.where(degenerate, 1.0, f), torch.where(degenerate, 0.0, s)


def intrinsics(focal: torch.Tensor, aspect_ratio: float) -> torch.Tensor:
    """(B, 3, 3) normalised intrinsics, principal point at the centre."""
    fx = focal / 2 * (1 + aspect_ratio ** 2) ** 0.5 / aspect_ratio
    fy = focal / 2 * (1 + aspect_ratio ** 2) ** 0.5
    k = torch.zeros(focal.shape[0], 3, 3, device=focal.device)
    k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2], k[:, 2, 2] = fx, fy, 0.5, 0.5, 1.0
    return k


def unproject(depth: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, H, W) depth and (B, 3, 3) intrinsics -> (B, H, W, 3) points."""
    h, w = depth.shape[-2:]
    u = ((torch.arange(w, device=depth.device, dtype=torch.float64) + 0.5) / w).float()
    v = ((torch.arange(h, device=depth.device, dtype=torch.float64) + 0.5) / h).float()
    fx, fy = k[:, 0, 0, None, None], k[:, 1, 1, None, None]
    x = (u[None, None, :] - k[:, 0, 2, None, None]) / fx * depth
    y = (v[None, :, None] - k[:, 1, 2, None, None]) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def postprocess(points: torch.Tensor, mask: torch.Tensor, aspect_ratio: float,
                normal: Optional[torch.Tensor] = None, metric_scale: Optional[torch.Tensor] = None,
                fov_x: Optional[float] = None, positive_depth: bool = True) -> dict:
    """The outputs of ``infer`` from the (B, H, W, 3) affine points and the
    (B, H, W) bool mask: camera solve (under the mask), depth shifted,
    points re-projected, metric scale applied, invalid pixels inf (normals 0).
    MoGe-2 also drops pixels of non-positive depth from the mask
    (``positive_depth``); MoGe-1 does not."""
    if fov_x is None:
        focal, shift = recover_focal_shift(points, mask)
    else:
        f = aspect_ratio / (1 + aspect_ratio ** 2) ** 0.5 / math.tan(math.radians(fov_x) / 2)
        focal, shift = recover_focal_shift(points, mask, torch.full((points.shape[0],), f, device=points.device))
    k = intrinsics(focal, aspect_ratio)
    depth = points[..., 2] + shift[:, None, None]
    if positive_depth:
        mask = mask & (depth > 0)
    pts = unproject(depth, k)
    if metric_scale is not None:
        pts = pts * metric_scale[:, None, None, None]
        depth = depth * metric_scale[:, None, None]
    out = {"points": torch.where(mask[..., None], pts, math.inf), "depth": torch.where(mask, depth, math.inf),
           "intrinsics": k, "mask": mask}
    if normal is not None:
        out["normal"] = torch.where(mask[..., None], normal, 0.0)
    return out
