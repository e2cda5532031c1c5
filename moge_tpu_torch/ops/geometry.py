"""Camera and geometry ops (port of moge_tpu/ops/geometry.py): uv grids,
intrinsics and field-of-view conversions, depth and point unprojection and
projection, the legacy closed-form focal/shift recovery, weighted means,
masked nearest resize, depth and normal edge masks, normals from points or
depth, sliding windows, masked dilation, normal-guided depth refinement and
a gaussian blur. OpenCV convention: x right, y down, z forward; normalized
image coordinates in [0, 1]; images (..., H, W[, C]). Each function runs on
its inputs' device and in their dtype; fixed-iteration loops stay fixed and
nothing waits on the device."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["normalized_view_plane_uv", "uv_map", "focal_to_fov", "fov_to_focal", "intrinsics_from_focal_center",
           "intrinsics_from_fov", "intrinsics_to_fov", "depth_map_to_point_map", "unproject_cv", "project_cv",
           "point_map_to_depth_legacy", "weighted_mean", "harmonic_mean", "geometric_mean", "safe_norm",
           "angle_diff_vec3", "angle_between", "masked_nearest_resize", "threshold_depth_change", "depth_map_edge",
           "normal_map_edge", "point_map_to_normal_map", "depth_map_to_normal_map", "sliding_window_2d",
           "dilate_with_mask", "refine_depth_with_normal", "gaussian_blur_2d"]

Dims = Optional[Union[int, Sequence[int]]]


def normalized_view_plane_uv(width: int, height: int, aspect_ratio: Optional[float] = None,
                             dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """UV grid spanning +-(w/diag, h/diag) at pixel centers, shape (H, W, 2)
    (computed in float64 on the host, like the JAX package)."""
    if aspect_ratio is None:
        aspect_ratio = width / height
    span_x = aspect_ratio / (1 + aspect_ratio ** 2) ** 0.5
    span_y = 1 / (1 + aspect_ratio ** 2) ** 0.5
    u = np.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width, width, dtype=np.float64)
    v = np.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height, height, dtype=np.float64)
    uu, vv = np.meshgrid(u, v, indexing="xy")
    return torch.as_tensor(np.stack([uu, vv], axis=-1), dtype=dtype, device=device)


def uv_map(height: int, width: int, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Pixel-center UV in [0, 1]^2, shape (H, W, 2)."""
    u = (np.arange(width, dtype=np.float64) + 0.5) / width
    v = (np.arange(height, dtype=np.float64) + 0.5) / height
    uu, vv = np.meshgrid(u, v, indexing="xy")
    return torch.as_tensor(np.stack([uu, vv], axis=-1), dtype=dtype, device=device)


def _tensor(x) -> torch.Tensor:
    """A tensor as it is; a number or array as float32 on the CPU (as jnp.asarray makes it)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float32)


def focal_to_fov(focal: torch.Tensor) -> torch.Tensor:
    return 2 * torch.atan(0.5 / focal)


def fov_to_focal(fov: torch.Tensor) -> torch.Tensor:
    return 0.5 / torch.tan(fov / 2)


def intrinsics_from_focal_center(fx, fy, cx, cy) -> torch.Tensor:
    """Normalized pinhole intrinsics (..., 3, 3) from broadcastable fx, fy, cx, cy."""
    ref = next(t for t in (fx, fy, cx, cy) if isinstance(t, torch.Tensor))
    fx, fy, cx, cy = torch.broadcast_tensors(
        *(torch.as_tensor(t, dtype=ref.dtype, device=ref.device) for t in (fx, fy, cx, cy)))
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    rows = [torch.stack([fx, zeros, cx], dim=-1),
            torch.stack([zeros, fy, cy], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1)]
    return torch.stack(rows, dim=-2)


def intrinsics_from_fov(fov_x=None, fov_y=None, cx=0.5, cy=0.5) -> torch.Tensor:
    """Normalized intrinsics from a horizontal and/or vertical field of view
    (radians); one of them alone gives equal focals."""
    if fov_x is not None and fov_y is not None:
        fx, fy = fov_to_focal(_tensor(fov_x)), fov_to_focal(_tensor(fov_y))
    else:
        fx = fy = fov_to_focal(_tensor(fov_x if fov_x is not None else fov_y))
    return intrinsics_from_focal_center(fx, fy, cx, cy)


def intrinsics_to_fov(intrinsics: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fov_x, fov_y) in radians from normalized intrinsics (..., 3, 3)."""
    return focal_to_fov(intrinsics[..., 0, 0]), focal_to_fov(intrinsics[..., 1, 1])


def depth_map_to_point_map(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject (..., H, W) depth with normalized intrinsics (..., 3, 3) ->
    (..., H, W, 3): x = (u - cx) / fx * z, y = (v - cy) / fy * z."""
    height, width = depth.shape[-2:]
    uv = uv_map(height, width, dtype=depth.dtype, device=depth.device)
    fx = intrinsics[..., 0, 0][..., None, None]
    fy = intrinsics[..., 1, 1][..., None, None]
    cx = intrinsics[..., 0, 2][..., None, None]
    cy = intrinsics[..., 1, 2][..., None, None]
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def unproject_cv(uv: torch.Tensor, depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject normalized uv (..., N, 2) and depth (..., N) -> points (..., N, 3)."""
    fx, fy = intrinsics[..., 0, 0][..., None], intrinsics[..., 1, 1][..., None]
    cx, cy = intrinsics[..., 0, 2][..., None], intrinsics[..., 1, 2][..., None]
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def project_cv(points: torch.Tensor, intrinsics: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project points (..., N, 3) -> (uv (..., N, 2), depth (..., N))."""
    z = points[..., 2]
    fx, fy = intrinsics[..., 0, 0][..., None], intrinsics[..., 1, 1][..., None]
    cx, cy = intrinsics[..., 0, 2][..., None], intrinsics[..., 1, 2][..., None]
    u = points[..., 0] / z * fx + cx
    v = points[..., 1] / z * fy + cy
    return torch.stack([u, v], dim=-1), z


def point_map_to_depth_legacy(points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form least-squares focal and shift of a point map (..., H, W, 3)
    (the reference's legacy recovery) -> (depth, fov_x, fov_y, shift)."""
    height, width = points.shape[-3], points.shape[-2]
    diagonal = (height ** 2 + width ** 2) ** 0.5
    uv = normalized_view_plane_uv(width, height, dtype=points.dtype, device=points.device)
    b = (uv * points[..., 2:]).reshape(*points.shape[:-3], -1)
    A = torch.stack([points[..., :2], -uv.expand_as(points[..., :2])], dim=-1).reshape(*points.shape[:-3], -1, 2)
    M = A.transpose(-2, -1) @ A
    Atb = A.transpose(-2, -1) @ b[..., None]
    eye = torch.eye(2, dtype=points.dtype, device=points.device)
    solution = (torch.linalg.inv(M + 1e-6 * eye) @ Atb)[..., 0]
    focal, shift = solution[..., 0], solution[..., 1]
    depth = points[..., 2] + shift[..., None, None]
    fov_x = torch.atan(width / diagonal / focal) * 2
    fov_y = torch.atan(height / diagonal / focal) * 2
    return depth, fov_x, fov_y, shift


def _mean(x: torch.Tensor, dim: Dims, keepdim: bool) -> torch.Tensor:
    return x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)


def weighted_mean(x: torch.Tensor, w: Optional[torch.Tensor] = None, dim: Dims = None, keepdim: bool = False,
                  eps: float = 1e-7) -> torch.Tensor:
    """mean(x * w) / (mean(w) + eps) over ``dim`` (all axes when None)."""
    if w is None:
        return _mean(x, dim, keepdim)
    w = w.to(x.dtype)
    return _mean(x * w, dim, keepdim) / (_mean(w, dim, keepdim) + eps)


def harmonic_mean(x: torch.Tensor, w: Optional[torch.Tensor] = None, dim: Dims = None, keepdim: bool = False,
                  eps: float = 1e-7) -> torch.Tensor:
    if w is None:
        return 1.0 / _mean(1.0 / (x + eps), dim, keepdim)
    return 1.0 / (weighted_mean(1.0 / (x + eps), w, dim, keepdim, eps) + eps)


def geometric_mean(x: torch.Tensor, w: Optional[torch.Tensor] = None, dim: Dims = None, keepdim: bool = False,
                   eps: float = 1e-7) -> torch.Tensor:
    if w is None:
        return torch.exp(_mean(torch.log(x + eps), dim, keepdim))
    return torch.exp(weighted_mean(torch.log(x + eps), w, dim, keepdim, eps))


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False, eps: float = 1e-20) -> torch.Tensor:
    """L2 norm with a finite gradient at 0."""
    return torch.sqrt(x.square().sum(dim=dim, keepdim=keepdim) + eps)


def angle_diff_vec3(v1: torch.Tensor, v2: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Angle between 3-vectors (last axis) via atan2."""
    return torch.atan2(safe_norm(torch.linalg.cross(v1, v2, dim=-1)) + eps, (v1 * v2).sum(-1))


def angle_between(v1: torch.Tensor, v2: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The angle between 3-vectors (utils3d's ``angle_between``; the atan2 form)."""
    return angle_diff_vec3(v1, v2, eps)


def masked_nearest_resize(*images: torch.Tensor, mask: torch.Tensor, size: Tuple[int, int],
                          return_index: bool = False):
    """Nearest resize that snaps each output pixel to the nearest *valid*
    input pixel: each target cell searches a window around its nearest source
    pixel and takes the closest valid one (first in window order on ties);
    the output mask marks cells whose window held a valid pixel.

    ``images``: (..., H, W, C) or (..., H, W) tensors sharing ``mask``
    (..., H, W) bool. Returns the resized images and mask (and, with
    ``return_index``, the source (row, col) index maps). Gradients flow to
    the images through the gathers."""
    height, width = mask.shape[-2:]
    out_h, out_w = size
    filter_h = math.ceil(height / out_h) if out_h < height else 1
    filter_w = math.ceil(width / out_w) if out_w < width else 1
    kh, kw = filter_h + (1 - filter_h % 2), filter_w + (1 - filter_w % 2)

    # nearest source centre per target pixel and the window around it (host, static)
    ti = (np.arange(out_h) + 0.5) * (height / out_h) - 0.5
    tj = (np.arange(out_w) + 0.5) * (width / out_w) - 0.5
    cand_i = np.clip(np.round(ti).astype(np.int64), 0, height - 1)[:, None] + np.arange(-(kh // 2), kh // 2 + 1)
    cand_j = np.clip(np.round(tj).astype(np.int64), 0, width - 1)[:, None] + np.arange(-(kw // 2), kw // 2 + 1)
    valid_i = (cand_i >= 0) & (cand_i < height)
    valid_j = (cand_j >= 0) & (cand_j < width)
    cand_i, cand_j = np.clip(cand_i, 0, height - 1), np.clip(cand_j, 0, width - 1)

    dev = mask.device
    as_t = lambda a, dtype: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    ci, cj = as_t(cand_i, torch.int64), as_t(cand_j, torch.int64)
    m = mask.index_select(-2, ci.reshape(-1)).reshape(*mask.shape[:-2], out_h, kh, width)
    m = m.index_select(-1, cj.reshape(-1)).reshape(*mask.shape[:-2], out_h, kh, out_w, kw)
    m = m & (as_t(valid_i, torch.bool)[:, :, None, None] & as_t(valid_j, torch.bool)[None, None])
    dist = (as_t((cand_i - ti[:, None]) ** 2, torch.float32)[:, :, None, None]
            + as_t((cand_j - tj[:, None]) ** 2, torch.float32)[None, None])
    dist = torch.where(m, dist, math.inf).movedim(-3, -2).flatten(-2)  # (..., out_h, out_w, kh*kw)
    best = dist.argmin(-1)
    out_mask = torch.isfinite(dist.amin(-1))
    src_i = ci[torch.arange(out_h, device=dev)[:, None], best // kw]
    src_j = cj[torch.arange(out_w, device=dev)[None, :], best % kw]
    flat_idx = (src_i * width + src_j).flatten(-2)  # (..., out_h * out_w)

    lead = mask.shape[:-2]
    outputs = []
    for img in images:
        if img.dim() == mask.dim() + 1:
            c = img.shape[-1]
            g = img.reshape(*lead, height * width, c).gather(-2, flat_idx[..., None].expand(*flat_idx.shape, c))
            outputs.append(g.reshape(*lead, out_h, out_w, c))
        else:
            outputs.append(img.reshape(*lead, height * width).gather(-1, flat_idx).reshape(*lead, out_h, out_w))
    if return_index:
        return (*outputs, out_mask, (src_i, src_j))
    return (*outputs, out_mask)


def _pool2d(x: torch.Tensor, kernel_size: int, mode: str) -> torch.Tensor:
    """Same-padded max or min pool over the last two axes (the padding never wins)."""
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    flat = x.reshape(-1, 1, h, w)
    sign = 1.0 if mode == "max" else -1.0
    pooled = sign * F.max_pool2d(sign * flat, kernel_size, stride=1, padding=kernel_size // 2)
    return pooled.reshape(*lead, h, w)


def threshold_depth_change(depth: torch.Tensor, mask: torch.Tensor, pooler: str, rtol: float = 0.2,
                           kernel_size: int = 3) -> torch.Tensor:
    """Pixels whose neighbourhood's max (min) depth over the mask exceeds
    (falls below) their depth by ``rtol``."""
    if pooler == "max":
        return _pool2d(torch.where(mask, depth, -math.inf), kernel_size, "max") > depth * (1 + rtol)
    if pooler == "min":
        return _pool2d(torch.where(mask, depth, math.inf), kernel_size, "min") < depth * (1 - rtol)
    raise ValueError(f"Unsupported pooler: {pooler}")


def depth_map_edge(depth: torch.Tensor, rtol: float = 0.04, kernel_size: int = 3,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Occlusion edges: masked pixels whose neighbourhood's max / min depth exceeds 1 + rtol."""
    if mask is None:
        mask = torch.isfinite(depth)
    d = torch.where(mask, depth, math.nan)
    dmax = _pool2d(torch.where(mask, d, -math.inf), kernel_size, "max")
    dmin = _pool2d(torch.where(mask, d, math.inf), kernel_size, "min")
    return ((dmax / dmin.clamp_min(1e-12)) > (1 + rtol)) & mask


def normal_map_edge(normals: torch.Tensor, tol_deg: float = 15.0, kernel_size: int = 3,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked pixels with a neighbour (in the window, over the mask) whose
    normal is more than ``tol_deg`` off theirs; the window wraps at the borders."""
    if mask is None:
        mask = torch.isfinite(normals).all(dim=-1)
    n = torch.where(mask[..., None], normals, 0.0)
    pad = kernel_size // 2
    dots = torch.full(mask.shape, math.inf, dtype=normals.dtype, device=normals.device)
    for di in range(-pad, pad + 1):
        for dj in range(-pad, pad + 1):
            if di == 0 and dj == 0:
                continue
            shifted = torch.roll(n, (di, dj), dims=(-3, -2))
            smask = torch.roll(mask, (di, dj), dims=(-2, -1))
            dots = torch.minimum(dots, torch.where(smask, (n * shifted).sum(-1), math.inf))
    return (dots < math.cos(math.radians(tol_deg))) & mask


def _pad_hw(x: torch.Tensor, top: int, bottom: int, left: int, right: int, channels: bool) -> torch.Tensor:
    """Zero (False) padding of the (H, W) axes, the last two or the two before a channel axis."""
    return F.pad(x, (0, 0, left, right, top, bottom) if channels else (left, right, top, bottom))


def point_map_to_normal_map(points: torch.Tensor,
                            mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel unit normals of a point map (..., H, W, 3) from the cross
    products of the four quads around each pixel, facing the camera, and
    their valid mask (a quad with all three pixels in the mask)."""
    if mask is None:
        mask = torch.isfinite(points).all(dim=-1)
    pts = torch.where(mask[..., None], points, 0.0)
    up = _pad_hw(pts[..., :-1, :, :] - pts[..., 1:, :, :], 1, 0, 0, 0, True)
    down = -_pad_hw(up[..., 1:, :, :], 0, 1, 0, 0, True)
    left = _pad_hw(pts[..., :, :-1, :] - pts[..., :, 1:, :], 0, 0, 1, 0, True)
    right = -_pad_hw(left[..., :, 1:, :], 0, 0, 0, 1, True)
    m = mask.to(torch.uint8)
    m_up = _pad_hw(m[..., 1:, :], 1, 0, 0, 0, False).bool()
    m_down = _pad_hw(m[..., :-1, :], 0, 1, 0, 0, False).bool()
    m_left = _pad_hw(m[..., :, 1:], 0, 0, 1, 0, False).bool()
    m_right = _pad_hw(m[..., :, :-1], 0, 0, 0, 1, False).bool()
    normal = torch.zeros_like(pts)
    count = torch.zeros(mask.shape, dtype=points.dtype, device=points.device)
    for a, b, va, vb in ((up, left, m_up, m_left), (left, down, m_left, m_down), (down, right, m_down, m_right),
                         (right, up, m_right, m_up)):
        v = (va & vb & mask).to(points.dtype)
        n = torch.linalg.cross(a, b, dim=-1)
        n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
        normal = normal + v[..., None] * n
        count = count + v
    valid = count > 0
    normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.where(valid[..., None], normal, 0.0), valid


def depth_map_to_normal_map(depth: torch.Tensor, intrinsics: torch.Tensor,
                            mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    return point_map_to_normal_map(depth_map_to_point_map(depth, intrinsics), mask=mask)


def sliding_window_2d(x: torch.Tensor, window_size: int, stride: int = 1) -> torch.Tensor:
    """(..., H, W) -> (..., H', W', k, k) windows (a view): out[..., y, x, i, j]
    = x[..., y * stride + i, x * stride + j]."""
    return x.unfold(-2, window_size, stride).unfold(-2, window_size, stride)


def dilate_with_mask(input: torch.Tensor, mask: torch.Tensor, filter: str = "mean",
                     iterations: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fill pixels outside ``mask`` from their valid 4-neighbours by min, max,
    mean or median (the lower middle), growing the mask by the cross each
    iteration -> (input, mask)."""
    kernel = torch.tensor([[False, True, False], [True, True, True], [False, True, False]], device=mask.device)
    for _ in range(iterations):
        input_window = sliding_window_2d(F.pad(input, (1, 1, 1, 1)), 3)
        mask_window = kernel & sliding_window_2d(F.pad(mask.to(torch.uint8), (1, 1, 1, 1)).bool(), 3)
        if filter == "min":
            filled = torch.where(mask_window, input_window, math.inf).amin((-2, -1))
        elif filter == "max":
            filled = torch.where(mask_window, input_window, -math.inf).amax((-2, -1))
        elif filter == "mean":
            total = torch.where(mask_window, input_window, 0.0).sum((-2, -1))
            filled = total / mask_window.sum((-2, -1)).clamp_min(1)
        elif filter == "median":
            vals = torch.where(mask_window, input_window, math.inf).reshape(*input.shape, 9).sort(-1).values
            idx = ((mask_window.sum((-2, -1)) - 1) // 2).clamp_min(0)
            filled = vals.gather(-1, idx[..., None])[..., 0]
        else:
            raise ValueError(f"Unsupported filter: {filter}")
        input = torch.where(mask, input, filled)
        mask = mask_window.any(-1).any(-1)
    return input, mask


def refine_depth_with_normal(depth: torch.Tensor, normal: torch.Tensor, intrinsics: torch.Tensor,
                             iterations: int = 10, damp: float = 1e-3, eps: float = 1e-12,
                             kernel_size: int = 5) -> torch.Tensor:
    """Normal-guided Jacobi refinement of log depth: ``iterations`` fixed
    steps that pull the depth map's finite differences towards the
    gradients its normal map implies (the reference's
    ``refine_depth_with_normal``)."""
    height, width = depth.shape[-2:]
    radius = kernel_size // 2
    du = np.linspace(-radius / width, radius / width, kernel_size)
    dv = np.linspace(-radius / height, radius / height, kernel_size)
    duu, dvv = np.meshgrid(du, dv, indexing="xy")
    duv = torch.as_tensor(np.stack([duu, dvv], axis=-1), dtype=depth.dtype, device=depth.device)  # (k, k, 2)

    log_depth = torch.log(depth.clamp_min(eps))
    inner = (Ellipsis, slice(radius, -radius), slice(radius, -radius))
    log_depth_diff = sliding_window_2d(log_depth, kernel_size) - log_depth[inner][..., None, None]
    duv_norm = safe_norm(duv, dim=-1).clamp_min(eps)
    weight = torch.exp(-(log_depth_diff / duv_norm / 10).square())
    tot_weight = weight.sum((-2, -1)).clamp_min(eps)

    uv = uv_map(height, width, dtype=depth.dtype, device=depth.device)
    k_inv = torch.linalg.inv(intrinsics)
    n_xy = normal[..., None, :2]
    a = k_inv[..., None, None, :2, :2]
    num = -(n_xy @ a)[..., 0, :]
    den = (normal[..., None, 2:] + n_xy @ (a @ uv[..., :, None] + k_inv[..., None, None, :2, 2:]))[..., 0, 0]
    grad = num / den[..., None]

    grad_windows = torch.stack([sliding_window_2d(grad[..., 0], kernel_size),
                                sliding_window_2d(grad[..., 1], kernel_size)], dim=-3)  # (..., H', W', 2, k, k)
    grad_center = grad[..., radius:-radius, radius:-radius, :, None, None]
    laplacian = (weight * ((grad_windows + grad_center) * (duv.movedim(-1, 0) / 2)).sum(-3)).sum((-2, -1))
    laplacian = laplacian.clamp(-0.1, 0.1)

    log_refine = log_depth
    for _ in range(iterations):
        neighborhood = (weight * sliding_window_2d(log_refine, kernel_size)).sum((-2, -1))
        update = 0.1 * log_refine[inner] + 0.9 * (damp * log_depth[inner] - laplacian + neighborhood) / (
            tot_weight + damp)
        log_refine = log_refine.clone()
        log_refine[inner] = update
    return torch.exp(log_refine)


def gaussian_blur_2d(x: torch.Tensor, kernel_size: int, sigma: float) -> torch.Tensor:
    """Replicate-padded gaussian blur over the last two axes (..., H, W)."""
    half = kernel_size // 2
    coords = np.arange(-kernel_size // 2 + 1, kernel_size // 2 + 1, dtype=np.float64)
    k1 = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    k1 = k1 / k1.sum()
    k2 = torch.as_tensor(np.outer(k1, k1), dtype=x.dtype, device=x.device)
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    xp = F.pad(x.reshape(-1, 1, h, w), (half, half, half, half), mode="replicate").reshape(*lead, h + 2 * half,
                                                                                          w + 2 * half)
    out = torch.zeros_like(x)
    for i in range(kernel_size):
        for j in range(kernel_size):
            out = out + k2[i, j] * xp[..., i:i + h, j:j + w]
    return out
