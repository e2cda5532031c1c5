"""Sanity-check inference for wrapped baselines (port of
moge_tpu/scripts/infer_baseline.py; reference moge/scripts/infer_baseline.py):
run a baseline adapter on a few images and dump its maps before committing
to a full benchmark run. cv2 and click are imported inside ``command``."""

from __future__ import annotations

import itertools
import warnings
from pathlib import Path

import numpy as np
import torch

__all__ = ["command", "main"]


def command():
    """The ``infer_baseline`` click command (click is imported here)."""
    import click

    @click.command(context_settings={"allow_extra_args": True, "ignore_unknown_options": True},
                   help="Inference script for wrapped baseline methods")
    @click.option("--baseline", "baseline_code_path", required=True, type=click.Path(),
                  help="Path to the baseline model python code, e.g. moge_tpu_torch/baselines/moge.py.")
    @click.option("--input", "-i", "input_path", type=str, required=True, help="Input image or folder")
    @click.option("--output", "-o", "output_path", type=str, default="./output", help="Output folder")
    @click.option("--size", "image_size", type=int, default=None, help="Resize input image")
    @click.option("--skip", is_flag=True, help="Skip existing output")
    @click.option("--maps", "save_maps_", is_flag=True, help="Save output point / depth maps")
    @click.option("--ply", "save_ply_", is_flag=True, help="Save mesh in PLY format")
    @click.option("--glb", "save_glb_", is_flag=True, help="Save mesh in GLB format")
    @click.option("--threshold", type=float, default=0.03, help="Depth edge threshold for mesh export")
    @click.pass_context
    def infer_baseline(ctx, baseline_code_path, input_path, output_path, image_size, skip, save_maps_, save_ply_,
                       save_glb_, threshold):
        import cv2

        from ..eval.baseline import MGEBaselineInterface
        from ..utils.geometry_numpy import depth_map_edge_numpy, uv_map_numpy
        from ..utils.io import write_exr
        from ..utils.mesh import image_mesh_from_map, save_glb, save_ply
        from ..utils.tools import import_file_as_module, timeit
        from ..utils.vis import colorize_depth, colorize_depth_affine, colorize_disparity

        module = import_file_as_module(baseline_code_path, Path(baseline_code_path).stem)
        baseline: MGEBaselineInterface = module.Baseline.load.main(ctx.args, standalone_mode=False)

        include_suffices = ["jpg", "png", "jpeg", "JPG", "PNG", "JPEG"]
        if Path(input_path).is_dir():
            image_paths = sorted(itertools.chain(*(Path(input_path).rglob(f"*.{s}") for s in include_suffices)))
        else:
            image_paths = [Path(input_path)]

        if not any([save_maps_, save_glb_, save_ply_]):
            warnings.warn("No output format specified. Defaults to saving maps only.")
            save_maps_ = True

        for image_path in image_paths:
            image_np = cv2.cvtColor(cv2.imread(str(image_path)), cv2.COLOR_BGR2RGB)
            height, width = image_np.shape[:2]
            if image_size is not None and max(image_np.shape[:2]) > image_size:
                height, width = min(image_size, int(image_size * height / width)), min(image_size, int(image_size * width / height))
                image_np = cv2.resize(image_np, (width, height), interpolation=cv2.INTER_AREA)

            with timeit("Inference", verbose=False) as timer:
                output = baseline.infer(image_np.astype(np.float32) / 255.0)
                output = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                          for k, v in output.items()}
            print(f"{image_path.name}: inference {timer.elapsed:.3f}s")

            if Path(input_path).is_dir():
                save_path = Path(output_path, image_path.relative_to(input_path).parent, image_path.stem)
            else:
                save_path = Path(output_path, image_path.stem)
            if skip and save_path.exists():
                continue
            save_path.mkdir(parents=True, exist_ok=True)

            if save_maps_:
                cv2.imwrite(str(save_path / "image.jpg"), cv2.cvtColor(image_np, cv2.COLOR_RGB2BGR))
                if "mask" in output:
                    cv2.imwrite(str(save_path / "mask.png"), (output["mask"] * 255).astype(np.uint8))
                for k in ["points_metric", "points_scale_invariant", "points_affine_invariant"]:
                    if k in output:
                        write_exr(save_path / "points.exr", output[k])
                for k in ["depth_metric", "depth_scale_invariant", "depth_affine_invariant"]:
                    if k in output:
                        write_exr(save_path / "depth.exr", output[k])
                        vis = colorize_depth(output[k]) if k != "depth_affine_invariant" else colorize_depth_affine(output[k])
                        cv2.imwrite(str(save_path / "depth_vis.png"), cv2.cvtColor(vis, cv2.COLOR_RGB2BGR))
                if "disparity_affine_invariant" in output:
                    cv2.imwrite(str(save_path / "disparity_vis.png"),
                                cv2.cvtColor(colorize_disparity(output["disparity_affine_invariant"]), cv2.COLOR_RGB2BGR))

            if save_glb_ or save_ply_:
                points_key = next((k for k in output if "points" in k), None)
                depth_key = next((k for k in output if "depth" in k), None)
                if points_key is not None and depth_key is not None:
                    points, depth = output[points_key], output[depth_key]
                    mask = output.get("mask", np.isfinite(depth)).astype(bool)
                    mask_cleaned = mask & ~depth_map_edge_numpy(depth, rtol=threshold)
                    faces, vertices, vertex_colors, vertex_uvs = image_mesh_from_map(
                        points, image_np.astype(np.float32) / 255, uv_map_numpy(height, width),
                        mask=mask_cleaned, tri=True,
                    )
                    vertices, vertex_uvs = vertices * [1, -1, -1], vertex_uvs * [1, -1] + [0, 1]
                    if save_glb_:
                        save_glb(save_path / "mesh.glb", vertices, faces, vertex_uvs, image_np)
                    if save_ply_:
                        save_ply(save_path / "mesh.ply", vertices, faces, vertex_colors)

    return infer_baseline


def main():
    command()()


if __name__ == "__main__":
    main()
