"""Deterministic evaluation dataloader (port of moge_tpu/eval/dataloader.py;
reference moge/test/dataloader.py).

Loads benchmark samples (image.jpg + log-PNG depth + meta.json [+
segmentation.png]) and applies the deterministic center perspective-crop to
the benchmark (width, height): rotate the view to center, shrink-to-fit the
target FoV, homography-remap image/depth (distance-preserving via ray
lengths), quantile-based max-depth drop, and segmentation label filtering.
All arrays are numpy (host); images are HWC float32 in [0, 1]. cv2 and PIL
are imported inside the functions that decode and resample.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from ..utils import pipeline
from ..utils.geometry_numpy import (
    depth_map_to_point_map_numpy,
    intrinsics_from_focal_center_numpy,
    masked_nearest_resize_numpy,
    norm3d,
    ray_intersection,
    rotation_matrix_from_vectors,
    unproject_cv_numpy,
    uv_map_numpy,
    uv_to_pixel_numpy,
)
from ..utils.io import read_depth, read_image, read_json, read_segmentation

__all__ = ["EvalDataLoaderPipeline"]


class EvalDataLoaderPipeline:
    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        split: str = ".index.txt",
        drop_max_depth: float = 1000.0,
        num_load_workers: int = 4,
        num_process_workers: int = 8,
        include_segmentation: bool = False,
        include_normal: bool = False,
        depth_to_normal: bool = False,
        max_segments: int = 100,
        min_seg_area: int = 1000,
        depth_unit: Optional[float] = None,
        has_sharp_boundary: bool = False,
        subset: Optional[int] = None,
    ):
        filenames = Path(path).joinpath(split).read_text(encoding="utf-8").splitlines()
        filenames = filenames[::subset]
        self.width = width
        self.height = height
        self.drop_max_depth = drop_max_depth
        self.path = Path(path)
        self.filenames = filenames
        self.include_segmentation = include_segmentation
        self.max_segments = max_segments
        self.min_seg_area = min_seg_area
        self.depth_unit = depth_unit
        self.has_sharp_boundary = has_sharp_boundary

        self.pipeline = pipeline.Sequential([
            self._generator,
            pipeline.Parallel([self._load_instance] * num_load_workers),
            pipeline.Parallel([self._process_instance] * num_process_workers),
            pipeline.Buffer(4),
        ])

    def __len__(self):
        return math.ceil(len(self.filenames))

    def _generator(self):
        for idx in range(len(self)):
            yield idx

    def _load_instance(self, idx):
        if idx >= len(self.filenames):
            return None
        path = self.path.joinpath(self.filenames[idx])
        instance: Dict[str, Any] = {
            "filename": self.filenames[idx],
            "width": self.width,
            "height": self.height,
        }
        instance["image"] = read_image(Path(path, "image.jpg"))
        depth = read_depth(Path(path, "depth.png"))
        instance.update({
            "depth": np.nan_to_num(depth, nan=1, posinf=1, neginf=1),
            "depth_mask": np.isfinite(depth),
            "depth_mask_inf": np.isinf(depth),
        })
        if self.include_segmentation and Path(path, "segmentation.png").exists():
            segmentation_mask, segmentation_labels = read_segmentation(Path(path, "segmentation.png"))
            instance.update({
                "segmentation_mask": segmentation_mask,
                "segmentation_labels": segmentation_labels,
            })
        meta = read_json(Path(path, "meta.json"))
        instance["intrinsics"] = np.array(meta["intrinsics"], dtype=np.float32)
        return instance

    def _process_instance(self, instance: Optional[dict]):
        import cv2
        from PIL import Image

        if instance is None:
            return None

        image, depth, depth_mask, intrinsics = (
            instance["image"], instance["depth"], instance["depth_mask"], instance["intrinsics"]
        )
        segmentation_mask = instance.get("segmentation_mask")
        segmentation_labels = instance.get("segmentation_labels")

        raw_height, raw_width = image.shape[:2]
        raw_horizontal, raw_vertical = abs(1.0 / intrinsics[0, 0]), abs(1.0 / intrinsics[1, 1])
        raw_pixel_w, raw_pixel_h = raw_horizontal / raw_width, raw_vertical / raw_height
        tgt_width, tgt_height = instance["width"], instance["height"]
        tgt_aspect = tgt_width / tgt_height

        tgt_horizontal = min(raw_horizontal, raw_vertical * tgt_aspect)
        tgt_vertical = tgt_horizontal / tgt_aspect

        # rotate the view to look at the principal direction (reference :119-121)
        direction = unproject_cv_numpy(
            np.array([[0.5, 0.5]], np.float32), np.array([1.0], np.float32), intrinsics
        )[0]
        R = rotation_matrix_from_vectors(direction, np.array([0, 0, 1], np.float32))

        # shrink-to-fit the target view within the raw view (reference :123-135)
        corners = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)
        corners = np.concatenate([corners, np.ones((4, 1), np.float32)], axis=1) @ (
            np.linalg.inv(intrinsics).T @ R.T
        )
        corners = corners[:, :2] / corners[:, 2:3]
        warp_horizontal, warp_vertical = raw_horizontal, raw_vertical
        for i in range(4):
            intersection, _ = ray_intersection(
                np.array([0.0, 0.0]), np.array([[tgt_aspect, 1.0], [tgt_aspect, -1.0]]),
                corners[i - 1], corners[i] - corners[i - 1],
            )
            warp_horizontal = min(warp_horizontal, 2 * np.abs(intersection[:, 0]).min())
            warp_vertical = min(warp_vertical, 2 * np.abs(intersection[:, 1]).min())
        tgt_horizontal = min(tgt_horizontal, warp_horizontal)
        tgt_vertical = min(tgt_vertical, warp_vertical)

        fx, fy = 1.0 / tgt_horizontal, 1.0 / tgt_vertical
        tgt_intrinsics = intrinsics_from_focal_center_numpy(fx, fy, 0.5, 0.5).astype(np.float32)

        # pre-resize to the target pixel density with Lanczos (reference :142-149)
        tgt_pixel_w, tgt_pixel_h = tgt_horizontal / tgt_width, tgt_vertical / tgt_height
        rescaled_w = int(raw_width * raw_pixel_w / tgt_pixel_w)
        rescaled_h = int(raw_height * raw_pixel_h / tgt_pixel_h)
        image = np.array(Image.fromarray(image).resize((rescaled_w, rescaled_h), Image.Resampling.LANCZOS))
        depth, depth_mask = masked_nearest_resize_numpy(depth, mask=depth_mask, size=(rescaled_h, rescaled_w))
        distance = norm3d(depth_map_to_point_map_numpy(depth, intrinsics))
        if segmentation_mask is not None:
            segmentation_mask = cv2.resize(segmentation_mask, (rescaled_w, rescaled_h), interpolation=cv2.INTER_NEAREST)

        # homography warp (reference :151-164)
        transform = intrinsics @ np.linalg.inv(R) @ np.linalg.inv(tgt_intrinsics)
        uv_tgt = uv_map_numpy(tgt_height, tgt_width)
        pts = np.concatenate([uv_tgt, np.ones((tgt_height, tgt_width, 1), np.float32)], axis=-1) @ transform.T
        uv_remap = pts[:, :, :2] / (pts[:, :, 2:3] + 1e-12)
        pixel_remap = uv_to_pixel_numpy(uv_remap, (rescaled_h, rescaled_w)).astype(np.float32)

        tgt_image = cv2.remap(image, pixel_remap[:, :, 0], pixel_remap[:, :, 1], cv2.INTER_LINEAR)
        tgt_distance = cv2.remap(distance, pixel_remap[:, :, 0], pixel_remap[:, :, 1], cv2.INTER_NEAREST)
        ray = unproject_cv_numpy(uv_tgt, np.ones_like(uv_tgt[:, :, 0]), tgt_intrinsics)
        tgt_depth = tgt_distance / (norm3d(ray) + 1e-12)
        tgt_depth_mask = cv2.remap(depth_mask.astype(np.uint8), pixel_remap[:, :, 0], pixel_remap[:, :, 1], cv2.INTER_NEAREST) > 0
        tgt_segmentation_mask = (
            cv2.remap(segmentation_mask, pixel_remap[:, :, 0], pixel_remap[:, :, 1], cv2.INTER_NEAREST)
            if segmentation_mask is not None else None
        )

        # drop far depth (reference :166-169)
        max_depth = np.nanquantile(np.where(tgt_depth_mask, tgt_depth, np.nan), 0.01) * self.drop_max_depth
        tgt_depth_mask &= tgt_depth <= max_depth
        tgt_depth = np.nan_to_num(tgt_depth, nan=0.0)

        if self.depth_unit is not None:
            tgt_depth = tgt_depth * self.depth_unit

        if not np.any(tgt_depth_mask):
            tgt_depth_mask = np.ones_like(tgt_depth_mask)
            tgt_depth = np.ones_like(tgt_depth)
            instance["label_type"] = "invalid"

        tgt_pts = unproject_cv_numpy(uv_tgt, tgt_depth, tgt_intrinsics)

        if self.include_segmentation and tgt_segmentation_mask is not None and segmentation_labels is not None:
            for k in ["undefined", "unannotated", "background", "sky"]:
                segmentation_labels.pop(k, None)
            seg_id2count = dict(zip(*np.unique(tgt_segmentation_mask, return_counts=True)))
            sorted_labels = sorted(
                segmentation_labels.keys(), key=lambda x: seg_id2count.get(segmentation_labels[x], 0), reverse=True
            )
            segmentation_labels = {
                k: segmentation_labels[k]
                for k in sorted_labels[: self.max_segments]
                if seg_id2count.get(segmentation_labels[k], 0) >= self.min_seg_area
            }

        instance.update({
            "image": tgt_image.astype(np.float32) / 255.0,  # HWC
            "depth": tgt_depth.astype(np.float32),
            "depth_mask": tgt_depth_mask.astype(bool),
            "intrinsics": tgt_intrinsics,
            "points": tgt_pts.astype(np.float32),
            "segmentation_mask": tgt_segmentation_mask,
            "segmentation_labels": segmentation_labels,
            "is_metric": self.depth_unit is not None,
            "has_sharp_boundary": self.has_sharp_boundary,
        })
        return {k: v for k, v in instance.items() if v is not None}

    def start(self):
        self.pipeline.start()

    def stop(self):
        self.pipeline.stop()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def get(self):
        return self.pipeline.get()
