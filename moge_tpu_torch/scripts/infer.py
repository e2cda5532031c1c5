"""Inference CLI (port of moge_tpu/scripts/infer.py): a file or a folder of
images in, per image the maps (depth.exr, points.exr, mask.png, colorized
depth/normal, fov.json) and/or a GLB mesh and a PLY point cloud out. The
host-side writers are the port's ``moge_tpu_torch.utils``; cv2 and click are
imported inside ``command``."""

from __future__ import annotations

import itertools
import json
import warnings
from pathlib import Path

import numpy as np
import torch

__all__ = ["command", "main"]


def command():
    """The ``infer`` click command (click is imported here, not with the module)."""
    import click

    @click.command(help="Inference script")
    @click.option("--input", "-i", "input_path", type=click.Path(exists=True), required=True,
                  help='Input image or folder path. "jpg" and "png" are supported.')
    @click.option("--fov_x", "fov_x_", type=float, default=None,
                  help="Horizontal field of view in degrees if known; otherwise estimated.")
    @click.option("--output", "-o", "output_path", default="./output", type=click.Path(), help="Output folder path")
    @click.option("--pretrained", "pretrained_path", type=str, required=True,
                  help="Local reference-format .pt checkpoint ({'model_config', 'model'}).")
    @click.option("--version", "model_version", type=click.Choice(["v1", "v2"]), default="v2", help="Model version.")
    @click.option("--device", "device_name", type=str, default="cuda", show_default=True,
                  help="Torch device; no fallback to the CPU when it is missing.")
    @click.option("--fp16", "use_fp16", is_flag=True, help="Use bf16 compute.")
    @click.option("--resize", "resize_to", type=int, default=None, help="Resize input so max(H,W)=N before inference.")
    @click.option("--resolution_level", type=int, default=9, help="Resolution level [0-9] controlling num_tokens.")
    @click.option("--num_tokens", type=int, default=None, help="Token count override.")
    @click.option("--threshold", type=float, default=0.04, help="Edge-removal threshold for mesh export.")
    @click.option("--maps", "save_maps_", is_flag=True, help="Save output maps and fov.json.")
    @click.option("--glb", "save_glb_", is_flag=True, help="Save a textured .glb mesh.")
    @click.option("--ply", "save_ply_", is_flag=True, help="Save a .ply point cloud.")
    @click.option("--show", "show", is_flag=True, help="Accepted for the reference's interface; only warns (headless).")
    def infer(input_path, fov_x_, output_path, pretrained_path, model_version, device_name,
              use_fp16, resize_to, resolution_level, num_tokens, threshold, save_maps_, save_glb_, save_ply_, show):
        import cv2

        from ..models import import_model_class_by_version
        from ..utils.geometry_numpy import depth_map_edge_numpy, intrinsics_to_fov_numpy, uv_map_numpy
        from ..utils.io import write_exr
        from ..utils.mesh import image_mesh_from_map, save_glb, save_ply
        from ..utils.vis import colorize_depth, colorize_normal

        device = torch.device(device_name)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise click.UsageError(f"--device {device_name}: no CUDA device (no fallback to the CPU)")
        include_suffices = ["jpg", "png", "jpeg", "JPG", "PNG", "JPEG"]
        if Path(input_path).is_dir():
            image_paths = sorted(itertools.chain(*(Path(input_path).rglob(f"*.{s}") for s in include_suffices)))
        else:
            image_paths = [Path(input_path)]
        if len(image_paths) == 0:
            raise FileNotFoundError(f"No image files found in {input_path}")

        model = import_model_class_by_version(model_version).from_pretrained(
            pretrained_path, device=device, dtype=torch.bfloat16 if use_fp16 else torch.float32)

        if not any([save_maps_, save_glb_, save_ply_]):
            warnings.warn('No output format specified. Defaults to saving all. Use "--maps", "--glb", or "--ply".')
            save_maps_ = save_glb_ = save_ply_ = True

        for image_path in image_paths:
            image = cv2.cvtColor(cv2.imread(str(image_path)), cv2.COLOR_BGR2RGB)
            height, width = image.shape[:2]
            if resize_to is not None:
                height, width = min(resize_to, int(resize_to * height / width)), min(resize_to, int(resize_to * width / height))
                image = cv2.resize(image, (width, height), interpolation=cv2.INTER_AREA)

            output = model.infer(torch.from_numpy(image.astype(np.float32) / 255.0), fov_x=fov_x_,
                                 resolution_level=resolution_level, num_tokens=num_tokens)
            output = {k: v.cpu().numpy() for k, v in output.items()}
            points, depth, mask, intrinsics = output["points"], output["depth"], output["mask"], output["intrinsics"]
            normal = output.get("normal")

            if Path(input_path).is_dir():
                save_path = Path(output_path, image_path.relative_to(input_path).parent, image_path.stem)
            else:
                save_path = Path(output_path, image_path.stem)
            save_path.mkdir(exist_ok=True, parents=True)

            if save_maps_:
                cv2.imwrite(str(save_path / "image.jpg"), cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
                cv2.imwrite(str(save_path / "depth_vis.png"), cv2.cvtColor(colorize_depth(depth), cv2.COLOR_RGB2BGR))
                write_exr(save_path / "depth.exr", depth)
                cv2.imwrite(str(save_path / "mask.png"), (mask * 255).astype(np.uint8))
                write_exr(save_path / "points.exr", points)
                if normal is not None:
                    cv2.imwrite(str(save_path / "normal.png"), cv2.cvtColor(colorize_normal(normal), cv2.COLOR_RGB2BGR))
                fov_x, fov_y = intrinsics_to_fov_numpy(intrinsics)
                (save_path / "fov.json").write_text(json.dumps({
                    "fov_x": round(float(np.rad2deg(fov_x)), 2),
                    "fov_y": round(float(np.rad2deg(fov_y)), 2),
                }))

            if save_glb_ or save_ply_:
                mask_cleaned = mask & ~depth_map_edge_numpy(depth, rtol=threshold)
                attrs = [points, image.astype(np.float32) / 255, uv_map_numpy(height, width)]
                if normal is not None:
                    attrs.append(normal)
                out = image_mesh_from_map(*attrs, mask=mask_cleaned, tri=True)
                faces, vertices, vertex_colors, vertex_uvs = out[0], out[1], out[2], out[3]
                vertex_normals = out[4] if normal is not None else None
                # OpenGL conventions
                vertices = vertices * [1, -1, -1]
                vertex_uvs = vertex_uvs * [1, -1] + [0, 1]
                if vertex_normals is not None:
                    vertex_normals = vertex_normals * [1, -1, -1]
                if len(vertices) == 0:
                    warnings.warn(f"No valid surface in {image_path} (empty mask); skipping mesh export.")
                else:
                    if save_glb_:
                        save_glb(save_path / "mesh.glb", vertices, faces, vertex_uvs, image, vertex_normals)
                    if save_ply_:
                        save_ply(save_path / "pointcloud.ply", vertices, np.zeros((0, 3), np.uint32), vertex_colors,
                                 vertex_normals)
            print(f"Saved results for {image_path} -> {save_path}")
        if show:
            warnings.warn("--show is not supported: this command runs headless and opens no viewer.")

    return infer


def main():
    command()()


if __name__ == "__main__":
    main()
