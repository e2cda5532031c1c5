"""Panorama inference (port of moge_tpu/scripts/infer_panorama.py; reference
moge/scripts/infer_panorama.py): the equirectangular image split into the 12
icosahedral 90-deg views, one batched ``infer`` with the known field of
view, distance = |points|, the gradient-domain merge, then the maps and the
meshes. ``infer_panorama`` is the pipeline; ``command`` the CLI around it
(cv2 and click are imported there, not with the module)."""

from __future__ import annotations

import itertools
import warnings
from pathlib import Path
from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["infer_panorama", "command", "main"]


def infer_panorama(model, image: Union[np.ndarray, torch.Tensor], *, resolution_level: int = 9,
                   batch_size: int = 12, merge_solver: str = "lsmr", split_resolution: int = 512,
                   merge_size: Tuple[int, int] = (1920, 960)) -> Dict[str, torch.Tensor]:
    """Run ``model`` (a v1 or v2 ``MoGeModel``) on an equirectangular (H, W,
    3) uint8 RGB image. The split, the views' ``infer`` and the merge's
    resampling run on the model's device; ``merge_solver`` "cg" solves there
    too, "lsmr" on the host. ``merge_size`` (width, height) caps the merge
    grid. Returns the panorama's ``depth`` (H, W), ``mask`` (H, W) and
    ``points`` (H, W, 3), and per view the uint8 ``views``, ``distances`` and
    ``view_masks``, all on the model's device. The wall time of the whole
    and of its stages goes to ``timeit.history`` under "panorama",
    "panorama split", "panorama infer" and "panorama merge" (each ended by a
    CUDA sync when a card is present)."""
    from ..panorama import get_panorama_cameras, merge_panorama_depth, spherical_uv_to_directions, \
        split_panorama_image
    from ..utils.geometry_numpy import intrinsics_to_fov_numpy, uv_map_numpy
    from ..utils.tools import timeit

    device = model.device
    with timeit("panorama", verbose=False):
        image = torch.as_tensor(image).to(device)
        height, width = image.shape[:2]
        extrinsics, intrinsics_list = get_panorama_cameras()
        with timeit("panorama split", verbose=False):
            views = split_panorama_image(image, extrinsics, intrinsics_list, split_resolution)

        with timeit("panorama infer", verbose=False):
            distances, masks = [], []
            for i in range(0, len(views), batch_size):
                batch = views[i:i + batch_size].float() / 255.0
                fov_x = float(np.rad2deg(intrinsics_to_fov_numpy(intrinsics_list[i])[0]))
                output = model.infer(batch, fov_x=fov_x, apply_mask=False, resolution_level=resolution_level)
                distances.append(torch.linalg.norm(output["points"], dim=-1))
                masks.append(output["mask"])
            distances, masks = torch.cat(distances), torch.cat(masks)

        merge_width, merge_height = min(merge_size[0], width), min(merge_size[1], height)
        with timeit("panorama merge", verbose=False):
            depth, mask = merge_panorama_depth(merge_width, merge_height, distances, masks, extrinsics,
                                               intrinsics_list, solver=merge_solver)
        # cv2.resize's INTER_LINEAR and INTER_NEAREST
        depth = F.interpolate(depth[None, None], size=(height, width), mode="bilinear", align_corners=False)[0, 0]
        mask = F.interpolate(mask[None, None].to(torch.uint8), size=(height, width), mode="nearest")[0, 0] > 0
        directions = torch.from_numpy(spherical_uv_to_directions(uv_map_numpy(height, width))).to(device)
        points = depth[..., None] * directions
    return {"depth": depth, "mask": mask, "points": points, "views": views, "distances": distances,
            "view_masks": masks}


def command():
    """The ``infer_panorama`` click command (click is imported here)."""
    import click

    @click.command(help="Inference script for panorama images")
    @click.option("--input", "-i", "input_path", type=click.Path(exists=True), required=True,
                  help="Input image or folder path.")
    @click.option("--output", "-o", "output_path", type=click.Path(), default="./output", help="Output folder path")
    @click.option("--pretrained", "pretrained_path", type=str, required=True,
                  help="Local reference-format .pt checkpoint ({'model_config', 'model'}).")
    @click.option("--version", "model_version", type=click.Choice(["v1", "v2"]), default="v1", help="Model version.")
    @click.option("--device", "device_name", type=str, default="cuda", show_default=True,
                  help="Torch device; no fallback to the CPU when it is missing.")
    @click.option("--fp16", "use_fp16", is_flag=True, help="Use bf16 compute.")
    @click.option("--resize", "resize_to", type=int, default=None, help="Resize the panorama before processing.")
    @click.option("--resolution_level", type=int, default=9, help="Resolution level [0-9].")
    @click.option("--threshold", type=float, default=0.03, help="Edge threshold for mesh export.")
    @click.option("--batch_size", type=int, default=12,
                  help="Batch size for per-view inference (12 = the whole icosahedral rig in one call).")
    @click.option("--merge_solver", type=click.Choice(["lsmr", "cg"]), default="lsmr",
                  help="Poisson merge solver: host scipy LSMR or conjugate gradient on the device.")
    @click.option("--splitted", "save_splitted", is_flag=True, help="Save the splitted views.")
    @click.option("--maps", "save_maps_", is_flag=True, help="Save output maps.")
    @click.option("--glb", "save_glb_", is_flag=True, help="Save textured .glb mesh.")
    @click.option("--ply", "save_ply_", is_flag=True, help="Save .ply mesh.")
    @click.option("--show", "show", is_flag=True, help="Accepted for the reference's interface; only warns (headless).")
    def infer_panorama_command(input_path, output_path, pretrained_path, model_version, device_name, use_fp16,
                               resize_to, resolution_level, threshold, batch_size, merge_solver, save_splitted,
                               save_maps_, save_glb_, save_ply_, show):
        import cv2

        from ..models import import_model_class_by_version
        from ..utils.geometry_numpy import depth_map_edge_numpy, normal_map_edge_numpy, \
            point_map_to_normal_map_numpy, uv_map_numpy
        from ..utils.io import write_exr
        from ..utils.mesh import image_mesh_from_map, save_glb, save_ply
        from ..utils.vis import colorize_depth

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

        if not any([save_maps_, save_glb_, save_ply_]):
            warnings.warn("No output format specified. Defaults to saving all.")
            save_maps_ = save_glb_ = save_ply_ = True

        model = import_model_class_by_version(model_version).from_pretrained(
            pretrained_path, device=device, dtype=torch.bfloat16 if use_fp16 else torch.float32)

        for image_path in image_paths:
            image = cv2.cvtColor(cv2.imread(str(image_path)), cv2.COLOR_BGR2RGB)
            height, width = image.shape[:2]
            if resize_to is not None:
                height, width = min(resize_to, int(resize_to * height / width)), min(resize_to, int(resize_to * width / height))
                image = cv2.resize(image, (width, height), interpolation=cv2.INTER_AREA)

            out = infer_panorama(model, image, resolution_level=resolution_level, batch_size=batch_size,
                                 merge_solver=merge_solver)
            panorama_depth, panorama_mask, points = (out[k].cpu().numpy() for k in ("depth", "mask", "points"))

            if save_splitted:
                sp = Path(output_path, image_path.stem, "splitted")
                sp.mkdir(exist_ok=True, parents=True)
                views, distances, masks = (out[k].cpu().numpy() for k in ("views", "distances", "view_masks"))
                for i in range(len(views)):
                    cv2.imwrite(str(sp / f"{i:02d}.jpg"), cv2.cvtColor(views[i], cv2.COLOR_RGB2BGR))
                    cv2.imwrite(str(sp / f"{i:02d}_distance_vis.png"),
                                cv2.cvtColor(colorize_depth(distances[i], masks[i]), cv2.COLOR_RGB2BGR))

            if Path(input_path).is_dir():
                save_path = Path(output_path, image_path.relative_to(input_path).parent, image_path.stem)
            else:
                save_path = Path(output_path, image_path.stem)
            save_path.mkdir(exist_ok=True, parents=True)
            if save_maps_:
                cv2.imwrite(str(save_path / "image.jpg"), cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
                cv2.imwrite(str(save_path / "depth_vis.png"),
                            cv2.cvtColor(colorize_depth(panorama_depth, mask=panorama_mask), cv2.COLOR_RGB2BGR))
                write_exr(save_path / "depth.exr", panorama_depth)
                write_exr(save_path / "points.exr", points)
                cv2.imwrite(str(save_path / "mask.png"), (panorama_mask * 255).astype(np.uint8))

            if save_glb_ or save_ply_:
                normals, normals_mask = point_map_to_normal_map_numpy(points, panorama_mask)
                edge = depth_map_edge_numpy(panorama_depth, rtol=threshold) & \
                    normal_map_edge_numpy(normals, tol_deg=5, mask=normals_mask)
                faces, vertices, vertex_colors, vertex_uvs = image_mesh_from_map(
                    points, image.astype(np.float32) / 255, uv_map_numpy(height, width),
                    mask=panorama_mask & ~edge, tri=True,
                )
                if save_glb_:
                    save_glb(save_path / "mesh.glb", vertices, faces, vertex_uvs, image)
                if save_ply_:
                    save_ply(save_path / "mesh.ply", vertices, faces, vertex_colors)
            print(f"Saved panorama results for {image_path} -> {save_path}")
        if show:
            warnings.warn("--show is not supported: this command runs headless and opens no viewer.")

    return infer_panorama_command


def main():
    command()()


if __name__ == "__main__":
    main()
