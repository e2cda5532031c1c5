"""Training dataloader (reference moge/train/dataloader.py:26-256; port of
moge_tpu/train/dataloader.py).

Host-side threaded pipeline: weighted dataset sampling, per-batch random
(aspect, area) target size, homography perspective augmentation with
disparity-space bilinear depth warping, flip + photometric augmentations,
quantile depth clamp, finite/infinite masks, invalid-instance placeholders on
load failure. Emits numpy batches (NHWC images) ready for the card.

The sampler draws from an explicit ``random.Random`` (the JAX package's
draws from the module-global ``random``, which its train loop shares with
the token-count draw): seeded with ``s`` it gives the batches the JAX
sampler gives under ``random.seed(s)``. Each instance's augmentation draws
from ``np.random.default_rng`` of the seed the sampler gave it, as in JAX.
``image_size_quantum`` rounds each batch's size down to a multiple (the JAX
train command patches its sampler to do so).

In a multi-process run ``batch_size`` is the global batch: rank ``rank`` of
``world`` runs the same sampler on the same stream, draws every instance's
descriptor and loads and augments only its share (``local_share``), so the
ranks' batches, in rank order, are the single-process batch instance for
instance.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from ..parallel.distributed import local_share
from ..utils import pipeline
from ..utils.data_augmentation import image_color_augmentation, sample_perspective, warp_perspective
from ..utils.geometry_numpy import (
    depth_map_edge_numpy,
    depth_map_to_normal_map_numpy,
    uv_map_numpy,
)
from ..utils.io import read_depth, read_image, read_json


__all__ = ["TrainDataLoaderPipeline"]


class TrainDataLoaderPipeline:
    def __init__(self, config: dict, batch_size: int, rng: random.Random, image_size_quantum: Optional[int] = None,
                 num_load_workers: int = 4, num_process_workers: int = 8, buffer_size: int = 8, rank: int = 0,
                 world: int = 1):
        self.config = config
        self.batch_size = batch_size
        self.share = local_share(batch_size, rank, world)
        self.rng = rng
        self.image_size_quantum = image_size_quantum
        self.clamp_max_depth = config["clamp_max_depth"]
        self.fov_range_absolute = config.get("fov_range_absolute", 0.0)
        self.fov_range_relative = config.get("fov_range_relative", 0.0)
        self.center_augmentation = config.get("center_augmentation", 0.0)
        self.image_augmentation = config.get("image_augmentation", [])

        if "image_sizes" in config:
            self.image_size_strategy = "fixed"
            self.image_sizes = config["image_sizes"]
        elif "aspect_ratio_range" in config and "area_range" in config:
            self.image_size_strategy = "aspect_area"
            self.aspect_ratio_range = config["aspect_ratio_range"]
            self.area_range = config["area_range"]
        else:
            raise ValueError("Invalid image size configuration")

        self.datasets = {}
        for dataset in config["datasets"]:
            name = dataset["name"]
            content = Path(dataset["path"], dataset.get("index", ".index.txt")).read_text()
            self.datasets[name] = {**dataset, "filenames": content.splitlines()}
        self.dataset_names = [d["name"] for d in config["datasets"]]
        self.dataset_weights = [d["weight"] for d in config["datasets"]]

        self.pipeline = pipeline.Sequential([
            self._sample_batch,
            pipeline.Unbatch(),
            pipeline.Parallel([self._load_instance] * num_load_workers),
            pipeline.Parallel([self._process_instance] * num_process_workers),
            pipeline.Batch(self.share.stop - self.share.start),
            self._collate_batch,
            pipeline.Buffer(buffer_size),
        ])

        self.invalid_instance = {
            "intrinsics": np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], np.float32),
            "image": np.zeros((256, 256, 3), np.uint8),
            "depth": np.ones((256, 256), np.float32),
            "depth_mask": np.ones((256, 256), bool),
            "depth_mask_inf": np.zeros((256, 256), bool),
            "label_type": "invalid",
        }

    def _sample_batch(self):
        rand = self.rng
        batch_id = 0
        while True:
            batch_id += 1
            batch = []
            for _ in range(self.batch_size):
                dataset_name = rand.choices(self.dataset_names, weights=self.dataset_weights)[0]
                filename = rand.choice(self.datasets[dataset_name]["filenames"])
                batch.append({
                    "batch_id": batch_id,
                    "seed": rand.randint(0, 2 ** 32 - 1),
                    "dataset": dataset_name,
                    "filename": filename,
                    "path": Path(self.datasets[dataset_name]["path"], filename),
                    "label_type": self.datasets[dataset_name]["label_type"],
                })

            if self.image_size_strategy == "fixed":
                width, height = rand.choice(self.config["image_sizes"])
            else:
                area = rand.uniform(*self.area_range)
                ranges = [
                    self.datasets[inst["dataset"]].get("aspect_ratio_range", self.aspect_ratio_range)
                    for inst in batch
                ]
                ar_range = (min(r[0] for r in ranges), max(r[1] for r in ranges))
                aspect_ratio = rand.uniform(*ar_range)
                width, height = int((area * aspect_ratio) ** 0.5), int((area / aspect_ratio) ** 0.5)
            q = self.image_size_quantum
            if q:
                width, height = max(q, width // q * q), max(q, height // q * q)
            batch = batch[self.share]
            for inst in batch:
                inst["width"], inst["height"] = width, height
            yield batch

    def _load_instance(self, instance: dict):
        try:
            image = read_image(Path(instance["path"], "image.jpg"))
            depth = read_depth(Path(instance["path"], self.datasets[instance["dataset"]].get("depth", "depth.png")))
            meta = read_json(Path(instance["path"], "meta.json"))
            instance.update({
                "image": image,
                "depth": depth,
                "intrinsics": np.array(meta["intrinsics"], np.float32),
            })
        except Exception as e:
            print(f"Failed to load instance {instance['dataset']}/{instance['filename']}: {e}")
            instance.update(self.invalid_instance)
        return instance

    def _process_instance(self, instance: Dict[str, Any]):
        raw_image, raw_depth, raw_intrinsics = instance["image"], instance["depth"], instance["intrinsics"]
        ds = self.datasets.get(instance["dataset"], {})
        # GT normal derived from depth (reference dataloader.py:145-146)
        raw_normal, raw_normal_mask = depth_map_to_normal_map_numpy(
            raw_depth, raw_intrinsics, mask=np.isfinite(raw_depth), edge_threshold=88
        )
        depth_unit = ds.get("depth_unit", None)

        tgt_width, tgt_height = instance["width"], instance["height"]
        tgt_aspect = tgt_width / tgt_height
        rng = np.random.default_rng(instance["seed"])

        tgt_intrinsics, R = sample_perspective(
            raw_intrinsics,
            tgt_aspect=tgt_aspect,
            center_augmentation=ds.get("center_augmentation", self.center_augmentation),
            fov_range_absolute=ds.get("fov_range_absolute", self.fov_range_absolute),
            fov_range_relative=ds.get("fov_range_relative", self.fov_range_relative),
            rng=rng,
        )
        transform = tgt_intrinsics @ R @ np.linalg.inv(raw_intrinsics)

        tgt_image = warp_perspective(raw_image, transform, (tgt_height, tgt_width), interpolation="lanczos")

        # depth warp: bilinear in disparity space away from edges, nearest at
        # edges / sparse regions (reference dataloader.py:171-178)
        depth_edge_mask = depth_map_edge_numpy(raw_depth, mask=np.isfinite(raw_depth), kernel_size=5, ltol=0.01)
        depth_bilinear_mask = np.isfinite(raw_depth) & ~depth_edge_mask
        with np.errstate(divide="ignore", invalid="ignore"):
            warped_bilinear_mask = warp_perspective(
                depth_bilinear_mask.astype(np.float32), transform, (tgt_height, tgt_width), interpolation="bilinear"
            )
            warped_nearest = warp_perspective(
                raw_depth, transform, (tgt_height, tgt_width), interpolation="nearest",
                sparse_mask=~np.isnan(raw_depth),
            )
            warped_bilinear = 1 / warp_perspective(1 / raw_depth, transform, (tgt_height, tgt_width), interpolation="bilinear")
        warped_depth = np.where(warped_bilinear_mask == 1.0, warped_bilinear, warped_nearest)
        uvhomo = np.concatenate(
            [uv_map_numpy(tgt_height, tgt_width), np.ones((tgt_height, tgt_width, 1), np.float32)], axis=-1
        )
        tgt_depth = warped_depth / np.dot(uvhomo, np.linalg.inv(transform)[2, :])

        warped_normal = warp_perspective(raw_normal, transform, (tgt_height, tgt_width), interpolation="bilinear")
        tgt_normal = warped_normal @ R.T

        if np.isfinite(tgt_depth).sum() / tgt_depth.size < 0.001:
            tgt_depth = np.ones_like(tgt_depth)
            instance["label_type"] = "invalid"

        # flip augmentation
        if rng.choice([True, False]):
            tgt_image = np.flip(tgt_image, axis=1).copy()
            tgt_depth = np.flip(tgt_depth, axis=1).copy()
            tgt_normal = np.flip(tgt_normal, axis=1).copy() * [-1, 1, 1]

        tgt_image = image_color_augmentation(
            tgt_image,
            augmentations=ds.get("image_augmentation", self.image_augmentation),
            rng=rng,
            depth=tgt_depth,
        )

        if depth_unit is not None:
            tgt_depth = tgt_depth * depth_unit
            instance["is_metric"] = True
        else:
            instance["is_metric"] = False

        with np.errstate(invalid="ignore"):
            max_depth = np.nanquantile(np.where(np.isfinite(tgt_depth), tgt_depth, np.nan), 0.01) * self.clamp_max_depth
            tgt_depth = np.where(np.isfinite(tgt_depth), np.clip(tgt_depth, 0, max_depth), tgt_depth)

        tgt_depth_mask_inf = np.isinf(tgt_depth)
        if ds.get("finite_depth_mask", None) == "only_known":
            tgt_depth_mask_fin = np.isfinite(tgt_depth)
        else:
            tgt_depth_mask_fin = ~tgt_depth_mask_inf

        instance.update({
            "image": tgt_image.astype(np.float32) / 255.0,  # HWC
            "depth": np.nan_to_num(tgt_depth, nan=1.0, posinf=1.0).astype(np.float32),
            "depth_mask_fin": tgt_depth_mask_fin & np.isfinite(tgt_depth),
            "depth_mask_inf": tgt_depth_mask_inf,
            "normal": np.nan_to_num(tgt_normal, nan=0.0).astype(np.float32),
            "normal_mask": np.isfinite(tgt_normal).all(axis=-1),
            "intrinsics": tgt_intrinsics,
        })
        return instance

    def _collate_batch(self, instances: List[Dict[str, Any]]):
        batch = {
            k: np.stack([inst[k] for inst in instances], axis=0)
            for k in ["image", "depth", "depth_mask_fin", "depth_mask_inf", "normal", "normal_mask", "intrinsics"]
        }
        batch["label_type"] = [inst["label_type"] for inst in instances]
        batch["is_metric"] = np.array([inst["is_metric"] for inst in instances])
        batch["info"] = [{"dataset": inst["dataset"], "filename": inst["filename"]} for inst in instances]
        return batch

    def get(self) -> Dict[str, Any]:
        return self.pipeline.get()

    def start(self):
        self.pipeline.start()

    def stop(self):
        self.pipeline.stop()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
