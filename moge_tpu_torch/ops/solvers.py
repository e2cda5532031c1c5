"""Batched camera recovery (port of moge_tpu/ops/solvers.py).

Recovers the focal and z-shift of an affine-invariant point map by solving

    min_s  sum_i w_i * | f(s) * xy_i / (z_i + s) - uv_i |^2,
    f(s) = sum_i w_i <proj_i, uv_i> / sum_i w_i |proj_i|^2   (closed form)

on a 64x64 legacy-nearest downsample with a fixed 30-iteration scalar
Levenberg-Marquardt loop, batched over images. The JAX package
differentiates the residual with ``jax.jvp``; here dr/ds is written out
analytically. Accept and damping rules are the JAX package's.

``recover_focal_shift`` runs kernel K5 (``csrc/camera_solve.cu``: one block
per image, the gather, the downsample and the whole LM loop in one launch,
no host synchronisation) for CUDA tensors and the plain version
(``_recover_plain``: ``solve_optimal_focal_shift`` / ``solve_optimal_shift``
on the downsampled map) for CPU tensors. The samples' uv and source pixels
come from a table built once per (H, W, downsample) and device on the host,
exactly as the plain path takes them, and copied from pinned memory.

K5 is the op ``moge::camera_solve(points, mask, focal, out_h, out_w,
iters)``. It takes no gradient, so a traced program records the op whatever
the device. Registration, routing and the launch count (kernel
``camera_solve``): ``_build``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from . import _build
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


def _recover_plain(points: torch.Tensor, mask: Optional[torch.Tensor], focal: Optional[torch.Tensor],
                   downsample_size: Tuple[int, int], iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: (focal, shift), each (B,), of ``points`` (B, H, W, 3),
    ``mask`` (B, H, W) or None and ``focal`` (B,) or None."""
    n_items, height, width, _ = points.shape
    pts = points.float()
    uv = normalized_view_plane_uv(width, height, dtype=torch.float32, device=points.device)

    pts_lr = resize_2d(pts, downsample_size, mode="nearest")
    uv_lr = resize_2d(uv, downsample_size, mode="nearest")
    if mask is None:
        w_lr = torch.ones(pts_lr.shape[:-1], dtype=torch.float32, device=points.device)
    else:
        w_lr = (resize_2d(mask.float(), downsample_size, mode="nearest", channel_last=False) > 0).float()

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
        est_focal = focal
        shift = solve_optimal_shift(flat_uv, flat_pts, est_focal, flat_w, iters)

    degenerate = n_valid < 2
    return torch.where(degenerate, 1.0, est_focal), torch.where(degenerate, 0.0, shift)


K5 = _build.Entry("camera_solve", "camera_solve", "moge_camera_solve",
                  [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p])


def sample_table(height: int, width: int, out_h: int, out_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The legacy-nearest samples of an (height, width) map as the plain
    version takes them, on the host: their uv, (N, 2) fp32 (the grid in
    float64, rounded once), and their flat source pixel y * width + x, (N,)
    int32, N = out_h * out_w in row-major order."""
    uv = normalized_view_plane_uv(width, height, dtype=torch.float32)
    pixel = torch.arange(height * width, dtype=torch.float64).reshape(height, width)
    uv = resize_2d(uv, (out_h, out_w), mode="nearest").reshape(-1, 2)
    pixel = resize_2d(pixel, (out_h, out_w), mode="nearest", channel_last=False).reshape(-1).to(torch.int32)
    return uv.contiguous(), pixel.contiguous()


@functools.lru_cache(maxsize=64)
def _device_table(height: int, width: int, out_h: int, out_w: int,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sample_table`` on ``device``, once per shape, by a copy from pinned
    memory that does not block the host (on the current stream, which K5's
    launches share)."""
    return tuple(t.pin_memory().to(device, non_blocking=True) for t in sample_table(height, width, out_h, out_w))


def _check(points: torch.Tensor, mask: Optional[torch.Tensor], focal: Optional[torch.Tensor]) -> None:
    """What ``moge::camera_solve`` takes: a contiguous fp32 (B, H, W, 3) map,
    a contiguous bool (B, H, W) mask or None, an fp32 (B,) focal or None, all
    on one device."""
    if points.dim() != 4 or points.shape[-1] != 3:
        raise ValueError(f"camera_solve takes a (B, H, W, 3) point map, got {tuple(points.shape)}")
    if points.dtype != torch.float32:
        raise TypeError(f"camera_solve takes float32 points, got {points.dtype}")
    if not points.is_contiguous():
        raise ValueError("camera_solve needs a contiguous point map")
    if points.shape[1] * points.shape[2] >= 2 ** 31:
        raise ValueError(f"camera_solve takes fewer than 2**31 pixels a map, got {tuple(points.shape[1:3])}")
    if mask is not None and (mask.shape != points.shape[:3] or mask.dtype != torch.bool or not mask.is_contiguous()
                             or mask.device != points.device):
        raise ValueError(f"camera_solve mask must be a contiguous bool {tuple(points.shape[:3])} tensor on "
                         f"{points.device}, got {mask.dtype} {tuple(mask.shape)} on {mask.device}")
    if focal is not None and (focal.shape != points.shape[:1] or focal.dtype != torch.float32
                              or focal.device != points.device):
        raise ValueError(f"camera_solve focal must be an fp32 {tuple(points.shape[:1])} tensor on {points.device}, "
                         f"got {focal.dtype} {tuple(focal.shape)} on {focal.device}")


def _launch(points: torch.Tensor, mask: Optional[torch.Tensor], focal: Optional[torch.Tensor], out_h: int,
            out_w: int, iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    _build.require_cuda_tensor(points, "camera_solve")
    _check(points, mask, focal)
    n_items, height, width, _ = points.shape
    est_focal = torch.empty(n_items, dtype=torch.float32, device=points.device)
    shift = torch.empty_like(est_focal)
    if n_items == 0:
        return est_focal, shift
    uv, pixel = _device_table(height, width, out_h, out_w, points.device)
    K5(None, points.device, points.data_ptr(), None if mask is None else mask.data_ptr(),
       None if focal is None else focal.data_ptr(), 0 if focal is None else focal.stride(0), uv.data_ptr(),
       pixel.data_ptr(), est_focal.data_ptr(), shift.data_ptr(), n_items, height * width, out_h * out_w, iters)
    return est_focal, shift


def _plain_op(points, mask, focal, out_h, out_w, iters):
    _check(points, mask, focal)
    return _recover_plain(points, mask, focal, (out_h, out_w), iters)


def _fake(points, mask, focal, out_h, out_w, iters):
    _check(points, mask, focal)
    return (points.new_empty(points.shape[:1], dtype=torch.float32),
            points.new_empty(points.shape[:1], dtype=torch.float32))


_build.define_op("camera_solve(Tensor points, Tensor? mask, Tensor? focal, int out_h, int out_w, int iters) "
                 "-> (Tensor, Tensor)", _launch, _plain_op, _fake)


def _kernel_args(points, mask, focal, downsample_size, iters):
    """The op's arguments: an fp32 contiguous map, a bool contiguous mask."""
    points = points.float().contiguous()
    if mask is not None:
        mask = (mask if mask.dtype == torch.bool else mask > 0).contiguous()
    return points, mask, focal, *downsample_size, iters


# no argument takes a gradient: a traced program records the op, a CPU
# tensor runs the plain version, anything else the launch
ROUTER = _build.Router("camera_solve", 0, lambda *args: torch.ops.moge.camera_solve(*_kernel_args(*args)),
                       _recover_plain, lambda *args: _launch(*_kernel_args(*args)), None)


def recover_focal_shift(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
                        focal: Optional[torch.Tensor] = None,
                        downsample_size: Tuple[int, int] = (64, 64),
                        iters: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """(focal, shift), each of shape (...), from an affine point map
    ``points`` (..., H, W, 3), an optional ``mask`` (..., H, W; nonzero keeps
    a pixel) and an optional known ``focal`` (...). Focal is relative to half
    the image diagonal. Items with fewer than 2 valid pixels return (1, 0).

    CUDA tensors run kernel K5 (one launch, no host synchronisation once the
    shape's sample table is on the card); CPU tensors run the plain version.
    A traced program (``torch.export``) records the op ``moge::camera_solve``."""
    *batch_shape, height, width, _ = points.shape
    pts = points.reshape(-1, height, width, 3)
    m = None if mask is None else mask.reshape(-1, height, width)
    f = focal
    if f is not None:
        f = torch.as_tensor(f, dtype=torch.float32, device=points.device).reshape(-1).expand(pts.shape[0])
    est_focal, shift = ROUTER(pts, m, f, tuple(downsample_size), iters)
    return est_focal.reshape(batch_shape), shift.reshape(batch_shape)
