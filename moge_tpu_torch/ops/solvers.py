"""Batched camera recovery (port of moge_tpu/ops/solvers.py).

Recovers the focal and z-shift of an affine-invariant point map by solving

    min_s  sum_i w_i * | f(s) * xy_i / (z_i + s) - uv_i |^2,
    f(s) = sum_i w_i <proj_i, uv_i> / sum_i w_i |proj_i|^2   (closed form)

on a 64x64 legacy-nearest downsample with a fixed 30-iteration scalar
Levenberg-Marquardt loop, batched over images, on the tensors' device. The
JAX package differentiates the residual with ``jax.jvp``; here dr/ds is
written out analytically. Accept and damping rules are the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .geometry import normalized_view_plane_uv
from .resize import resize_2d

__all__ = ["recover_focal_shift", "solve_optimal_focal_shift", "solve_optimal_shift"]

_EPS = 1e-12


def _lm_minimize_shift(residual: Callable, s0: torch.Tensor, iters: int = 30,
                       lam0: float = 1e-3) -> torch.Tensor:
    """Scalar LM per batch item. ``residual(s, jvp)`` -> (r, dr/ds or None),
    each (B, R)."""
    s = s0
    lam = torch.full_like(s0, lam0)
    for _ in range(iters):
        r, dr = residual(s, True)
        f_cur = r.square().sum(-1)
        g = (r * dr).sum(-1)
        h = dr.square().sum(-1)
        s_new = s - g / (h * (1.0 + lam) + _EPS)
        f_new = residual(s_new, False)[0].square().sum(-1)
        accept = (f_new < f_cur) & torch.isfinite(f_new)
        s = torch.where(accept, s_new, s)
        lam = torch.where(accept, (lam / 3.0).clamp_min(1e-9), (lam * 10.0).clamp_max(1e8))
    return s


def solve_optimal_focal_shift(uv: torch.Tensor, points: torch.Tensor, weight: torch.Tensor,
                              iters: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """min over (s, f) of |f * xy/(z+s) - uv|, f in closed form per iterate.
    ``uv`` (B, N, 2), ``points`` (B, N, 3), ``weight`` (B, N). -> (shift, focal), each (B,)."""
    xy, z = points[..., :2], points[..., 2]
    sw = weight.sqrt()[..., None]
    w = weight[..., None]

    def focal_of(proj):
        num = (w * proj * uv).sum((-2, -1))
        den = (w * proj.square()).sum((-2, -1))
        return num, den

    def residual(s, jvp):
        zs = (z + s[:, None])[..., None]
        proj = xy / zs
        num, den = focal_of(proj)
        den_c = den.clamp_min(_EPS)
        f = (num / den_c)[:, None, None]
        r = (sw * (f * proj - uv)).flatten(1)
        if not jvp:
            return r, None
        dproj = -proj / zs
        dnum = (w * dproj * uv).sum((-2, -1))
        dden = 2.0 * (w * proj * dproj).sum((-2, -1))
        df = dnum / den_c - num * torch.where(den > _EPS, dden, 0.0) / den_c.square()
        dr = (sw * (df[:, None, None] * proj + f * dproj)).flatten(1)
        return r, dr

    shift = _lm_minimize_shift(residual, torch.zeros_like(z[:, 0]), iters)
    num, den = focal_of(xy / (z + shift[:, None])[..., None])
    return shift, num / den.clamp_min(_EPS)


def solve_optimal_shift(uv: torch.Tensor, points: torch.Tensor, focal: torch.Tensor,
                        weight: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """min over s of |focal * xy/(z+s) - uv| (focal known, (B,)) -> shift (B,)."""
    xy, z = points[..., :2], points[..., 2]
    sw = weight.sqrt()[..., None]
    f = focal[:, None, None]

    def residual(s, jvp):
        zs = (z + s[:, None])[..., None]
        proj = xy / zs
        r = (sw * (f * proj - uv)).flatten(1)
        if not jvp:
            return r, None
        return r, (sw * f * (-proj / zs)).flatten(1)

    return _lm_minimize_shift(residual, torch.zeros_like(z[:, 0]), iters)


def recover_focal_shift(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
                        focal: Optional[torch.Tensor] = None,
                        downsample_size: Tuple[int, int] = (64, 64),
                        iters: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """(focal, shift), each of shape (...), from an affine point map
    ``points`` (..., H, W, 3), an optional bool ``mask`` (..., H, W) and an
    optional known ``focal`` (...). Focal is relative to half the image
    diagonal. Items with fewer than 2 valid pixels return (1, 0)."""
    *batch_shape, height, width, _ = points.shape
    pts = points.reshape(-1, height, width, 3).float()
    n_items = pts.shape[0]
    uv = normalized_view_plane_uv(width, height, dtype=torch.float32, device=points.device)

    pts_lr = resize_2d(pts, downsample_size, mode="nearest")
    uv_lr = resize_2d(uv, downsample_size, mode="nearest")
    if mask is None:
        w_lr = torch.ones(pts_lr.shape[:-1], dtype=torch.float32, device=points.device)
    else:
        m = mask.reshape(-1, height, width).float()
        w_lr = (resize_2d(m, downsample_size, mode="nearest", channel_last=False) > 0).float()

    n_valid = w_lr.sum((-2, -1))
    # keep the solve NaN-free for degenerate items: weight-0 points get z = 1
    unit_z = torch.tensor([0.0, 0.0, 1.0], device=points.device)
    safe_pts = torch.where(w_lr[..., None] > 0, pts_lr, unit_z)

    n_px = downsample_size[0] * downsample_size[1]
    flat_uv = uv_lr.reshape(1, n_px, 2).expand(n_items, n_px, 2)
    flat_pts = safe_pts.reshape(n_items, n_px, 3)
    flat_w = w_lr.reshape(n_items, n_px)

    if focal is None:
        shift, est_focal = solve_optimal_focal_shift(flat_uv, flat_pts, flat_w, iters)
    else:
        est_focal = torch.as_tensor(focal, dtype=torch.float32, device=points.device).reshape(-1)
        est_focal = est_focal.expand(n_items)
        shift = solve_optimal_shift(flat_uv, flat_pts, est_focal, flat_w, iters)

    degenerate = n_valid < 2
    est_focal = torch.where(degenerate, 1.0, est_focal)
    shift = torch.where(degenerate, 0.0, shift)
    return est_focal.reshape(batch_shape), shift.reshape(batch_shape)
