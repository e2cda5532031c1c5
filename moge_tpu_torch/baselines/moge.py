"""The port's MoGe models as an eval baseline (counterpart of the repo's
``baselines/moge.py``, reference baselines/moge.py): v1 gives scale-invariant
outputs, v2 metric ones. Point ``eval_baseline``/``infer_baseline`` at this
file: ``--baseline moge_tpu_torch/baselines/moge.py --pretrained <model.pt>``.
click is imported when ``Baseline.load`` is read, not with the module."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from moge_tpu_torch.eval.baseline import MGEBaselineInterface
from moge_tpu_torch.utils.geometry_numpy import intrinsics_to_fov_numpy


class _Command:
    """Class attribute that builds a click command when it is read."""

    def __init__(self, factory):
        self.factory = factory

    def __get__(self, obj, owner):
        return self.factory()


def _load_command():
    import click

    @click.command()
    @click.option("--num_tokens", type=int, default=None)
    @click.option("--resolution_level", type=int, default=9)
    @click.option("--pretrained", "pretrained_path", type=str, required=True,
                  help="Local reference-format .pt checkpoint ({'model_config', 'model'}).")
    @click.option("--fp16", "use_fp16", is_flag=True, help="Use bf16 compute.")
    @click.option("--version", type=click.Choice(["v1", "v2"]), default="v2")
    @click.option("--device", "device_name", type=str, default="cuda", show_default=True,
                  help="Torch device; no fallback to the CPU when it is missing.")
    def load(num_tokens, resolution_level, pretrained_path, use_fp16, version, device_name):
        device = torch.device(device_name)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise click.UsageError(f"--device {device_name}: no CUDA device (no fallback to the CPU)")
        return Baseline(num_tokens, resolution_level, pretrained_path, use_fp16, version, device)

    return load


class Baseline(MGEBaselineInterface):
    load = _Command(_load_command)

    def __init__(self, num_tokens: Optional[int], resolution_level: int, pretrained_path: str, use_fp16: bool,
                 version: str = "v2", device="cuda"):
        from moge_tpu_torch.models import import_model_class_by_version

        self.version = version
        self.device = torch.device(device)
        self.model = import_model_class_by_version(version).from_pretrained(
            pretrained_path, device=self.device, dtype=torch.bfloat16 if use_fp16 else torch.float32)
        self.num_tokens = num_tokens
        self.resolution_level = resolution_level

    def _run(self, image: np.ndarray, intrinsics: Optional[np.ndarray], apply_mask: bool):
        fov_x = None
        if intrinsics is not None:
            fov_x = float(np.rad2deg(intrinsics_to_fov_numpy(np.asarray(intrinsics))[0]))
        output = self.model.infer(torch.from_numpy(np.asarray(image, np.float32)).to(self.device), fov_x=fov_x,
                                  apply_mask=apply_mask, num_tokens=self.num_tokens,
                                  resolution_level=self.resolution_level)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        output = {k: v.cpu().numpy() for k, v in output.items()}
        if self.version == "v1":
            return {
                "points_scale_invariant": output["points"],
                "depth_scale_invariant": output["depth"],
                "intrinsics": output["intrinsics"],
            }
        return {
            "points_metric": output["points"],
            "depth_metric": output["depth"],
            "intrinsics": output["intrinsics"],
        }

    def infer(self, image, intrinsics=None):
        return self._run(image, intrinsics, apply_mask=True)

    def infer_for_evaluation(self, image, intrinsics=None):
        return self._run(image, intrinsics, apply_mask=False)
