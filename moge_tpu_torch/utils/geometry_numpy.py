"""Host-side numpy geometry of the CLI, the panorama, the eval loader and
the training loader: weighted and harmonic means, the view-plane and
pixel-center uv maps, intrinsics from and to a field
of view, depth to points and normals, occlusion edges (depth ratio and disparity window) and normal edges, the masked
nearest resize, OpenCV-convention projection, the 2D helpers of the loaders'
crop and warp, and the depth-of-field blur of the training augmentation.
Copies of the matching functions of the JAX package's
``moge_tpu/utils/geometry_numpy.py``."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["weighted_mean_numpy", "harmonic_mean_numpy", "normalized_view_plane_uv_numpy", "uv_map_numpy",
           "focal_to_fov_numpy", "fov_to_focal_numpy", "intrinsics_to_fov_numpy",
           "intrinsics_from_focal_center_numpy", "intrinsics_from_fov_numpy", "depth_map_to_point_map_numpy",
           "point_map_to_normal_map_numpy", "depth_map_to_normal_map_numpy", "depth_map_edge_numpy",
           "depth_occlusion_edge_numpy", "normal_map_edge_numpy",
           "masked_nearest_resize_numpy", "norm3d", "unproject_cv_numpy", "project_cv_numpy", "uv_to_pixel_numpy",
           "rotation_matrix_from_vectors", "ray_intersection", "disk_kernel", "disk_blur", "depth_of_field"]


def weighted_mean_numpy(x, w=None, axis=None, keepdims=False, eps=1e-7):
    if w is None:
        return np.mean(x, axis=axis, keepdims=keepdims)
    w = w.astype(x.dtype)
    return (x * w).mean(axis=axis, keepdims=keepdims) / np.clip(w.mean(axis=axis, keepdims=keepdims), eps, None)


def harmonic_mean_numpy(x, w=None, axis=None, keepdims=False, eps=1e-7):
    if w is None:
        return 1 / (1 / np.clip(x, eps, None)).mean(axis=axis, keepdims=keepdims)
    w = w.astype(x.dtype)
    return 1 / (weighted_mean_numpy(1 / (x + eps), w, axis=axis, keepdims=keepdims, eps=eps) + eps)


def normalized_view_plane_uv_numpy(width: int, height: int, aspect_ratio: Optional[float] = None,
                                   dtype=np.float32) -> np.ndarray:
    """UV grid spanning +-(w/diag, h/diag) at pixel centers, (H, W, 2)."""
    if aspect_ratio is None:
        aspect_ratio = width / height
    span_x = aspect_ratio / (1 + aspect_ratio ** 2) ** 0.5
    span_y = 1 / (1 + aspect_ratio ** 2) ** 0.5
    u = np.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width, width, dtype=dtype)
    v = np.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height, height, dtype=dtype)
    u, v = np.meshgrid(u, v, indexing="xy")
    return np.stack([u, v], axis=-1)


def uv_map_numpy(height: int, width: int, dtype=np.float32) -> np.ndarray:
    u = (np.arange(width, dtype=dtype) + 0.5) / width
    v = (np.arange(height, dtype=dtype) + 0.5) / height
    uu, vv = np.meshgrid(u, v, indexing="xy")
    return np.stack([uu, vv], axis=-1)


def focal_to_fov_numpy(focal):
    return 2 * np.arctan(0.5 / focal)


def intrinsics_to_fov_numpy(intrinsics: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return focal_to_fov_numpy(intrinsics[..., 0, 0]), focal_to_fov_numpy(intrinsics[..., 1, 1])


def depth_map_edge_numpy(
    depth: np.ndarray,
    rtol: Optional[float] = 0.04,
    ltol: Optional[float] = None,
    kernel_size: int = 3,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Occlusion-edge mask via local max/min depth ratio (utils3d `depth_map_edge`).

    ``rtol``: relative ratio threshold (dmax/dmin > 1+rtol);
    ``ltol``: log-space threshold (log dmax - log dmin > ltol).
    """
    import cv2

    if mask is None:
        mask = np.isfinite(depth)
    kernel = np.ones((kernel_size, kernel_size), np.uint8)
    d = depth.astype(np.float32)
    dmax = cv2.dilate(np.where(mask, d, -np.inf).astype(np.float32), kernel)
    dmin = -cv2.dilate(np.where(mask, -d, -np.inf).astype(np.float32), kernel)
    edge = np.zeros_like(mask)
    with np.errstate(invalid="ignore", divide="ignore"):
        if ltol is not None:
            edge |= (np.log(np.maximum(dmax, 1e-12)) - np.log(np.maximum(dmin, 1e-12))) > ltol
        elif rtol is not None:
            edge |= (dmax / np.maximum(dmin, 1e-12)) > (1 + rtol)
    return edge & mask


def fov_to_focal_numpy(fov):
    return 0.5 / np.tan(fov / 2)


def intrinsics_from_focal_center_numpy(fx, fy, cx, cy) -> np.ndarray:
    fx, fy, cx, cy = np.broadcast_arrays(fx, fy, cx, cy)
    z, o = np.zeros_like(fx), np.ones_like(fx)
    return np.stack([
        np.stack([fx, z, cx], -1), np.stack([z, fy, cy], -1), np.stack([z, z, o], -1)
    ], axis=-2).astype(np.float32)


def intrinsics_from_fov_numpy(fov_x=None, fov_y=None, cx=0.5, cy=0.5) -> np.ndarray:
    fx = fov_to_focal_numpy(fov_x) if fov_x is not None else fov_to_focal_numpy(fov_y)
    fy = fov_to_focal_numpy(fov_y) if fov_y is not None else fx
    return intrinsics_from_focal_center_numpy(fx, fy, cx, cy)


def depth_map_to_point_map_numpy(depth: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    height, width = depth.shape[-2:]
    uv = uv_map_numpy(height, width, dtype=depth.dtype)
    fx = intrinsics[..., 0, 0][..., None, None]
    fy = intrinsics[..., 1, 1][..., None, None]
    cx = intrinsics[..., 0, 2][..., None, None]
    cy = intrinsics[..., 1, 2][..., None, None]
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return np.stack([x, y, depth], axis=-1)


def point_map_to_normal_map_numpy(points: np.ndarray, mask: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel normals from a point map — pure numpy (data-pipeline hot path;
    same quad-cross-product scheme as ops.geometry.point_map_to_normal_map)."""
    if mask is None:
        mask = np.isfinite(points).all(axis=-1)
    pts = np.where(mask[..., None], points, 0.0).astype(np.float32)

    pad_width = [(0, 0)] * (pts.ndim - 3)
    up = np.pad(pts[..., :-1, :, :] - pts[..., 1:, :, :], pad_width + [(1, 0), (0, 0), (0, 0)])
    down = -np.pad(up[..., 1:, :, :], pad_width + [(0, 1), (0, 0), (0, 0)])
    left = np.pad(pts[..., :, :-1, :] - pts[..., :, 1:, :], pad_width + [(0, 0), (1, 0), (0, 0)])
    right = -np.pad(left[..., :, 1:, :], pad_width + [(0, 0), (0, 1), (0, 0)])

    mpad = [(0, 0)] * (mask.ndim - 2)
    m_up = np.pad(mask[..., 1:, :], mpad + [(1, 0), (0, 0)])
    m_down = np.pad(mask[..., :-1, :], mpad + [(0, 1), (0, 0)])
    m_left = np.pad(mask[..., :, 1:], mpad + [(0, 0), (1, 0)])
    m_right = np.pad(mask[..., :, :-1], mpad + [(0, 0), (0, 1)])

    normal = np.zeros_like(pts)
    count = np.zeros(mask.shape, np.float32)
    for a, b, va, vb in [
        (up, left, m_up, m_left),
        (left, down, m_left, m_down),
        (down, right, m_down, m_right),
        (right, up, m_right, m_up),
    ]:
        v = (va & vb & mask).astype(np.float32)
        n = np.cross(a, b)
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        normal += v[..., None] * n
        count += v
    valid = count > 0
    normal = normal / np.maximum(np.linalg.norm(normal, axis=-1, keepdims=True), 1e-12)
    return np.where(valid[..., None], normal, 0.0).astype(np.float32), valid


def depth_map_to_normal_map_numpy(
    depth: np.ndarray,
    intrinsics: np.ndarray,
    mask: Optional[np.ndarray] = None,
    edge_threshold: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Normals from depth (utils3d `depth_map_to_normal_map`): unproject, quad
    cross-products; ``edge_threshold`` (degrees) invalidates normals nearly
    perpendicular to the viewing ray (grazing surfaces / depth edges)."""
    if mask is None:
        mask = np.isfinite(depth)
    points = depth_map_to_point_map_numpy(np.where(mask, depth, 1.0), intrinsics)
    normal, valid = point_map_to_normal_map_numpy(points, mask)
    if edge_threshold is not None:
        ray = points / np.maximum(norm3d(points)[..., None], 1e-12)
        cos_angle = -np.sum(normal * ray, axis=-1)  # normals face the camera
        grazing = np.abs(cos_angle) < np.cos(np.deg2rad(edge_threshold))
        valid = valid & ~grazing
    return np.where(valid[..., None], normal, np.nan).astype(np.float32), valid


def normal_map_edge_numpy(normals: np.ndarray, tol_deg: float = 15.0, kernel_size: int = 3, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Edge mask where local normal direction varies beyond tolerance (numpy)."""
    if mask is None:
        mask = np.isfinite(normals).all(axis=-1)
    n = np.where(mask[..., None], normals, 0.0).astype(np.float32)
    pad = kernel_size // 2
    dots = np.full(mask.shape, np.inf, np.float32)
    for di in range(-pad, pad + 1):
        for dj in range(-pad, pad + 1):
            if di == 0 and dj == 0:
                continue
            shifted = np.roll(n, (di, dj), axis=(-3, -2))
            smask = np.roll(mask, (di, dj), axis=(-2, -1))
            d = np.where(smask, np.sum(n * shifted, axis=-1), np.inf)
            dots = np.minimum(dots, d)
    return (dots < np.cos(np.deg2rad(tol_deg))) & mask


def masked_nearest_resize_numpy(*images, mask: np.ndarray, size: Tuple[int, int], return_index: bool = False):
    """Nearest-valid-pixel resize — pure numpy (data-pipeline hot path; same
    window-search semantics as ops.geometry.masked_nearest_resize)."""
    import math

    height, width = mask.shape[-2:]
    out_h, out_w = size
    filter_h = math.ceil(height / out_h) if out_h < height else 1
    filter_w = math.ceil(width / out_w) if out_w < width else 1
    filter_size = (filter_h + (1 - filter_h % 2), filter_w + (1 - filter_w % 2))
    pad_h, pad_w = filter_size[0] // 2, filter_size[1] // 2

    ti = (np.arange(out_h) + 0.5) * (height / out_h) - 0.5
    tj = (np.arange(out_w) + 0.5) * (width / out_w) - 0.5
    ci = np.clip(np.round(ti).astype(np.int64), 0, height - 1)
    cj = np.clip(np.round(tj).astype(np.int64), 0, width - 1)

    offs_i = np.arange(-pad_h, pad_h + 1)
    offs_j = np.arange(-pad_w, pad_w + 1)
    cand_i = ci[:, None] + offs_i[None, :]
    cand_j = cj[:, None] + offs_j[None, :]
    valid_i = (cand_i >= 0) & (cand_i < height)
    valid_j = (cand_j >= 0) & (cand_j < width)
    cand_i = np.clip(cand_i, 0, height - 1)
    cand_j = np.clip(cand_j, 0, width - 1)
    dist_i = (cand_i - ti[:, None]) ** 2
    dist_j = (cand_j - tj[:, None]) ** 2

    batch_shape = mask.shape[:-2]
    m = mask[..., cand_i[:, :, None, None], cand_j[None, None, :, :]]
    m = m & (valid_i[:, :, None, None] & valid_j[None, None, :, :])
    dist = np.where(m, dist_i[:, :, None, None] + dist_j[None, None, :, :], np.inf)
    dist = np.moveaxis(dist, -3, -2).reshape(*batch_shape, out_h, out_w, -1)
    best = dist.argmin(axis=-1)
    out_mask = np.isfinite(dist.min(axis=-1))
    kw = len(offs_j)
    best_ki, best_kj = best // kw, best % kw
    src_i = cand_i[np.arange(out_h)[:, None], best_ki]
    src_j = cand_j[np.arange(out_w)[None, :], best_kj]

    outputs = []
    for img in images:
        if img.ndim == mask.ndim:
            if mask.ndim == 2:
                out = img[src_i, src_j]
            else:
                out = np.take_along_axis(
                    img.reshape(*batch_shape, -1), (src_i * width + src_j).reshape(*batch_shape, -1), axis=-1
                ).reshape(*batch_shape, out_h, out_w)
        else:
            c = img.shape[-1]
            flat = img.reshape(*batch_shape, height * width, c)
            idx = (src_i * width + src_j).reshape(*batch_shape, -1)
            out = np.take_along_axis(flat, idx[..., None].repeat(c, axis=-1), axis=-2)
            out = out.reshape(*batch_shape, out_h, out_w, c)
        outputs.append(out)
    if return_index:
        return (*outputs, out_mask, (src_i, src_j))
    return (*outputs, out_mask)


def norm3d(x: np.ndarray) -> np.ndarray:
    return np.sqrt(np.square(x[..., 0]) + np.square(x[..., 1]) + np.square(x[..., 2]))


def unproject_cv_numpy(uv: np.ndarray, depth: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """Unproject normalized uv + depth -> camera points (utils3d `unproject_cv`)."""
    fx, fy = intrinsics[..., 0, 0], intrinsics[..., 1, 1]
    cx, cy = intrinsics[..., 0, 2], intrinsics[..., 1, 2]
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return np.stack([x, y, depth], axis=-1)


def project_cv_numpy(points: np.ndarray, intrinsics: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    z = points[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = points[..., 0] / z * intrinsics[..., 0, 0] + intrinsics[..., 0, 2]
        v = points[..., 1] / z * intrinsics[..., 1, 1] + intrinsics[..., 1, 2]
    return np.stack([u, v], axis=-1), z


def uv_to_pixel_numpy(uv: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    h, w = hw[:2]
    return np.stack([uv[..., 0] * w - 0.5, uv[..., 1] * h - 0.5], axis=-1)


def rotation_matrix_from_vectors(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Rotation R with R @ v1 = v2 (utils3d `rotation_matrix_from_vectors`,
    Rodrigues form)."""
    v1 = v1 / np.linalg.norm(v1)
    v2 = v2 / np.linalg.norm(v2)
    axis = np.cross(v1, v2)
    c = float(np.dot(v1, v2))
    s = float(np.linalg.norm(axis))
    if s < 1e-12:
        if c > 0:
            return np.eye(3, dtype=np.float32)
        # opposite: rotate 180 deg around any perpendicular axis
        perp = np.array([1.0, 0, 0]) if abs(v1[0]) < 0.9 else np.array([0, 1.0, 0])
        axis = np.cross(v1, perp)
        axis /= np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        return (np.eye(3) + 2 * K @ K).astype(np.float32)
    axis = axis / s
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = np.eye(3) + s * K + (1 - c) * (K @ K)
    return R.astype(np.float32)


def ray_intersection(p1: np.ndarray, d1: np.ndarray, p2: np.ndarray, d2: np.ndarray):
    """2D ray intersection points (utils3d `ray_intersection`), batched.

    Solves p1 + t1 d1 = p2 + t2 d2 for each broadcasted pair; returns
    (intersection points (..., 2), t1 (...)).
    """
    p1, d1, p2, d2 = np.broadcast_arrays(
        np.atleast_2d(p1), np.atleast_2d(d1), np.atleast_2d(p2), np.atleast_2d(d2)
    )
    cross = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        dp = p2 - p1
        t1 = (dp[..., 0] * d2[..., 1] - dp[..., 1] * d2[..., 0]) / cross
    pts = p1 + t1[..., None] * d1
    return pts, t1


def depth_occlusion_edge_numpy(depth: np.ndarray, mask: np.ndarray, thickness: int = 1,
                               tol: float = 0.1) -> np.ndarray:
    """Occlusion edges from a disparity window (reference geometry_numpy.py):
    pixels in front of (behind) their window's masked mean disparity by
    ``tol``, where a foreground and a background edge meet, dilated by
    ``thickness``."""
    import cv2
    from numpy.lib.stride_tricks import sliding_window_view

    disp = np.where(mask, 1 / depth, 0)
    disp_pad = np.pad(disp, (thickness, thickness), constant_values=0)
    mask_pad = np.pad(mask, (thickness, thickness), constant_values=False)
    kernel_size = 2 * thickness + 1
    disp_window = sliding_window_view(disp_pad, (kernel_size, kernel_size))
    mask_window = sliding_window_view(mask_pad, (kernel_size, kernel_size))
    disp_mean = weighted_mean_numpy(disp_window, mask_window, axis=(-2, -1))
    fg_edge_mask = mask & (disp > (1 + tol) * disp_mean)
    bg_edge_mask = mask & (disp_mean > (1 + tol) * disp)
    kernel = np.ones((3, 3), dtype=np.uint8)
    return ((cv2.dilate(fg_edge_mask.astype(np.uint8), kernel, iterations=thickness) > 0)
            & (cv2.dilate(bg_edge_mask.astype(np.uint8), kernel, iterations=thickness) > 0))


def disk_kernel(radius: int) -> np.ndarray:
    """(2r+1, 2r+1) normalized disk kernel (reference geometry_numpy.py:164-181)."""
    L = np.arange(-radius, radius + 1)
    X, Y = np.meshgrid(L, L)
    kernel = ((X ** 2 + Y ** 2) <= radius ** 2).astype(np.float32)
    kernel /= np.sum(kernel)
    return kernel


def disk_blur(image: np.ndarray, radius: int) -> np.ndarray:
    """FFT disk blur (reference geometry_numpy.py:184-208)."""
    from scipy.signal import fftconvolve

    if radius == 0:
        return image
    kernel = disk_kernel(radius)
    if image.ndim == 2:
        return fftconvolve(image, kernel, mode="same")
    if image.ndim == 3:
        return np.stack([fftconvolve(image[..., i], kernel, mode="same") for i in range(image.shape[2])], axis=-1)
    raise ValueError("Image must be 2D or 3D.")


def depth_of_field(img: np.ndarray, disp: np.ndarray, focus_disp: float, max_blur_radius: int = 10) -> np.ndarray:
    """Depth-of-field augmentation (reference geometry_numpy.py:211-261)."""
    import cv2

    max_disp = np.max(disp)
    disp = disp / max_disp
    focus_disp = focus_disp / max_disp
    dilated_disp = []
    for radius in range(max_blur_radius + 1):
        dilated_disp.append(
            cv2.dilate(disp, cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * radius + 1, 2 * radius + 1)), iterations=1)
        )
    blur_radii = np.clip(abs(disp - focus_disp) * max_blur_radius, 0, max_blur_radius).astype(np.int32)
    for radius in range(max_blur_radius + 1):
        dilated_blur_radii = np.clip(abs(dilated_disp[radius] - focus_disp) * max_blur_radius, 0, max_blur_radius).astype(np.int32)
        m = (dilated_blur_radii >= radius) & (dilated_blur_radii >= blur_radii) & (dilated_disp[radius] > disp)
        blur_radii[m] = dilated_blur_radii[m]
    blur_radii = np.clip(blur_radii, 0, max_blur_radius)
    blur_radii = cv2.blur(blur_radii, (5, 5))

    unique_radii = np.unique(blur_radii)
    precomputed = {r: disk_blur(img, r) for r in range(max_blur_radius + 1) if r in unique_radii}
    output = np.zeros_like(img)
    for r in unique_radii:
        m = blur_radii == r
        output[m] = precomputed[r][m]
    return output
