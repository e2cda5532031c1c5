"""Training-time augmentation (reference moge/utils/data_augmentation.py).

Host-side numpy/cv2: perspective (homography) augmentation with FOV sampling
and view-shrink-to-fit, careful multi-mode warping, and photometric
augmentations (jittering/dof/shot_noise/blurring/jpeg_loss). The torchvision
color jitter calls are replaced by numpy equivalents with the same blend
semantics. Copies of the JAX package's ``moge_tpu/utils/data_augmentation.py``
functions; every random draw comes from the caller's ``np.random.Generator``,
and cv2 and PIL are imported inside the functions that use them.
"""

from __future__ import annotations

from typing import List, Literal, Optional, Tuple

import numpy as np

from .geometry_numpy import (
    depth_of_field,
    focal_to_fov_numpy,
    fov_to_focal_numpy,
    intrinsics_from_focal_center_numpy,
    intrinsics_to_fov_numpy,
    masked_nearest_resize_numpy,
    ray_intersection,
    rotation_matrix_from_vectors,
    unproject_cv_numpy,
)


__all__ = ["sample_perspective", "warp_perspective", "image_color_augmentation"]


def sample_perspective(
    src_intrinsics: np.ndarray,
    tgt_aspect: float,
    center_augmentation: float,
    fov_range_absolute: Tuple[float, float],
    fov_range_relative: Tuple[float, float],
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample target intrinsics + rotation for homography aug (reference :21-68)."""
    rng = rng or np.random.default_rng()
    raw_fov_x, raw_fov_y = intrinsics_to_fov_numpy(src_intrinsics)

    fov_abs_min, fov_abs_max = fov_range_absolute
    fov_rel_min, fov_rel_max = fov_range_relative
    tgt_fov_x_min = min(
        fov_rel_min * raw_fov_x,
        focal_to_fov_numpy(fov_to_focal_numpy(fov_rel_min * raw_fov_y) / tgt_aspect),
    )
    tgt_fov_x_max = min(
        fov_rel_max * raw_fov_x,
        focal_to_fov_numpy(fov_to_focal_numpy(fov_rel_max * raw_fov_y) / tgt_aspect),
    )
    tgt_fov_x_min = max(np.deg2rad(fov_abs_min), tgt_fov_x_min)
    tgt_fov_x_max = min(np.deg2rad(fov_abs_max), tgt_fov_x_max)
    tgt_fov_x = rng.uniform(min(tgt_fov_x_min, tgt_fov_x_max), tgt_fov_x_max)
    tgt_fov_y = focal_to_fov_numpy(fov_to_focal_numpy(tgt_fov_x) * tgt_aspect)

    center_dtheta = center_augmentation * rng.uniform(-0.5, 0.5) * (raw_fov_x - tgt_fov_x)
    center_dphi = center_augmentation * rng.uniform(-0.5, 0.5) * (raw_fov_y - tgt_fov_y)
    cu = 0.5 + 0.5 * np.tan(center_dtheta) / np.tan(raw_fov_x / 2)
    cv_ = 0.5 + 0.5 * np.tan(center_dphi) / np.tan(raw_fov_y / 2)
    direction = unproject_cv_numpy(
        np.array([[cu, cv_]], np.float32), np.array([1.0], np.float32), src_intrinsics
    )[0]
    R = rotation_matrix_from_vectors(direction, np.array([0, 0, 1], np.float32))

    corners = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)
    corners = np.concatenate([corners, np.ones((4, 1), np.float32)], axis=1) @ (
        np.linalg.inv(src_intrinsics).T @ R.T
    )
    corners = corners[:, :2] / corners[:, 2:3]
    tgt_horizontal, tgt_vertical = np.tan(tgt_fov_x / 2) * 2, np.tan(tgt_fov_y / 2) * 2
    warp_horizontal = warp_vertical = float("inf")
    for i in range(4):
        intersection, _ = ray_intersection(
            np.array([0.0, 0.0]), np.array([[tgt_aspect, 1.0], [tgt_aspect, -1.0]]),
            corners[i - 1], corners[i] - corners[i - 1],
        )
        warp_horizontal = min(warp_horizontal, 2 * np.abs(intersection[:, 0]).min())
        warp_vertical = min(warp_vertical, 2 * np.abs(intersection[:, 1]).min())
    tgt_horizontal = min(tgt_horizontal, warp_horizontal)
    tgt_vertical = min(tgt_vertical, warp_vertical)

    fx, fy = 1 / tgt_horizontal, 1 / tgt_vertical
    tgt_intrinsics = intrinsics_from_focal_center_numpy(fx, fy, 0.5, 0.5).astype(np.float32)
    return tgt_intrinsics, R


def warp_perspective(
    src_map: np.ndarray,
    transform: np.ndarray,
    tgt_size: Tuple[int, int],
    interpolation: Literal["nearest", "bilinear", "lanczos"] = "nearest",
    sparse_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Homography warping with careful resampling (reference :71-111)."""
    import cv2
    from PIL import Image

    tgt_height, tgt_width = tgt_size
    src_height, src_width = src_map.shape[:2]

    def pixel_transform(sw, sh):
        return (
            np.array([[tgt_width, 0, -0.5], [0, tgt_height, -0.5], [0, 0, 1]], np.float32)
            @ transform
            @ np.array([[1 / sw, 0, 0.5 / sw], [0, 1 / sh, 0.5 / sh], [0, 0, 1]], np.float32)
        )

    tp = pixel_transform(src_width, src_height)
    w = np.dot(np.linalg.inv(tp)[2, :], np.array([tgt_width / 2, tgt_height / 2, 1], np.float32))
    scale_x, scale_y = w * np.linalg.norm(tp[:2, :2], axis=0)

    if interpolation == "lanczos" and (scale_x < 0.8 or scale_y < 0.8):
        src_height = max(round(src_map.shape[0] * scale_y * 1.25), 16)
        src_width = max(round(src_map.shape[1] * scale_x * 1.25), 16)
        src_map = np.array(Image.fromarray(src_map).resize((src_width, src_height), Image.Resampling.LANCZOS))
    elif interpolation == "nearest" and sparse_mask is not None and (scale_x < 1 or scale_y < 1):
        src_height = max(round(src_map.shape[0] * scale_y), 16)
        src_width = max(round(src_map.shape[1] * scale_x), 16)
        src_map, _ = masked_nearest_resize_numpy(src_map, mask=sparse_mask, size=(src_height, src_width))

    tp = pixel_transform(src_width, src_height)
    cv2_interp = {"nearest": cv2.INTER_NEAREST, "bilinear": cv2.INTER_LINEAR, "lanczos": cv2.INTER_LANCZOS4}[interpolation]
    return cv2.warpPerspective(np.ascontiguousarray(src_map), tp, (tgt_width, tgt_height), flags=cv2_interp)


def _blend(a: np.ndarray, b, factor: float) -> np.ndarray:
    return np.clip(factor * a.astype(np.float32) + (1 - factor) * b, 0, 255).astype(np.uint8)


def _grayscale(image: np.ndarray) -> np.ndarray:
    return image @ np.array([0.299, 0.587, 0.114], np.float32)


def image_color_augmentation(
    image: np.ndarray,
    augmentations: List[str],
    rng: Optional[np.random.Generator] = None,
    depth: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Photometric augmentations (reference :114-148). numpy equivalents of the
    torchvision jitter ops (same blend formulas)."""
    import cv2

    height, width = image.shape[:2]
    rng = rng or np.random.default_rng()
    if "jittering" in augmentations:
        image = _blend(image, 0.0, rng.uniform(0.9, 1.1))                      # brightness
        image = _blend(image, _grayscale(image).mean(), rng.uniform(0.9, 1.1))  # contrast
        image = _blend(image, _grayscale(image)[..., None], rng.uniform(0.9, 1.1))  # saturation
        hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV)                           # hue
        shift = rng.uniform(-0.05, 0.05) * 180
        hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(shift)) % 180
        image = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
        gamma = rng.uniform(0.9, 1.1)                                          # gamma
        image = (np.power(image.astype(np.float32) / 255.0, gamma) * 255).clip(0, 255).astype(np.uint8)
    if "dof" in augmentations:
        assert depth is not None, "Depth map is required for DOF augmentation"
        if rng.uniform() < 0.5:
            dof_strength = int(rng.integers(12))
            disp = 1 / depth
            # a depth of 0 has an infinite disparity: the JAX package's mask
            # (finite depth) takes it into the range and raises OverflowError
            # in the uniform draw; elsewhere the two masks are equal
            finite_mask = np.isfinite(depth) & np.isfinite(disp)
            if finite_mask.any():
                disp_min, disp_max = disp[finite_mask].min(), disp[finite_mask].max()
                disp = cv2.inpaint(
                    np.nan_to_num(disp, nan=1).astype(np.float32),
                    np.isnan(disp).astype(np.uint8), 3, cv2.INPAINT_TELEA,
                ).clip(0, disp_max)
                dof_focus = rng.uniform(disp_min, disp_max)
                image = depth_of_field(image, disp, dof_focus, dof_strength)
    if "shot_noise" in augmentations:
        if rng.uniform() < 0.5:
            k = np.exp(rng.uniform(np.log(100), np.log(10000))) / 255
            image = (rng.poisson(image * k) / k).clip(0, 255).astype(np.uint8)
    if "blurring" in augmentations:
        if rng.uniform() < 0.5:
            ratio = rng.uniform(0.25, 1)
            down = cv2.resize(image, (int(width * ratio), int(height * ratio)), interpolation=cv2.INTER_AREA)
            up_interp = rng.choice([cv2.INTER_LINEAR_EXACT, cv2.INTER_CUBIC, cv2.INTER_LANCZOS4])
            image = cv2.resize(down, (width, height), interpolation=int(up_interp))
    if "jpeg_loss" in augmentations:
        if rng.uniform() < 0.5:
            image = cv2.imdecode(
                cv2.imencode(".jpg", image, [cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(20, 100))])[1],
                cv2.IMREAD_COLOR,
            )
    return image
