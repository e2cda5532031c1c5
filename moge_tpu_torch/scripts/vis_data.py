"""Dataset instance inspection (port of moge_tpu/scripts/vis_data.py;
reference moge/scripts/vis_data.py): for every folder under the argument
that holds image.jpg + a depth PNG + meta.json (the training layout), a
colorized depth picture and/or a PLY point cloud. Host-side only: the
port's codecs (``utils/io.py``), PLY writer (``utils/mesh.py``) and
colorization (``utils/vis.py``, which needs matplotlib); cv2 and click are
imported inside ``command``."""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["command", "main"]


def command():
    """The ``vis_data`` click command (click is imported here, not with the module)."""
    import click

    @click.command(help="Visualize dataset instances: colorized depth and/or a PLY point cloud")
    @click.argument("folder_or_path", type=click.Path(exists=True))
    @click.option("--output", "-o", "output_folder", type=click.Path(), help="Path to output folder")
    @click.option("--max_depth", "-m", type=float, default=float("inf"),
                  help="Keep points nearer than this multiple of the nearest depth")
    @click.option("--depth", "depth_filename", type=str, default="depth.png", help="depth image file name")
    @click.option("--ply", "save_ply_", is_flag=True, help="save point cloud as PLY file")
    @click.option("--depth_vis", "save_depth_vis", is_flag=True, help="save colorized depth image")
    def vis_data(folder_or_path, output_folder, max_depth, depth_filename, save_ply_, save_depth_vis):
        import cv2

        from ..utils.geometry_numpy import unproject_cv_numpy, uv_map_numpy
        from ..utils.io import read_depth, read_image, read_json
        from ..utils.mesh import save_ply
        from ..utils.vis import colorize_depth

        filepaths = sorted(p.parent for p in Path(folder_or_path).rglob("meta.json"))
        if not filepaths:
            raise click.UsageError(f"No meta.json found under {folder_or_path}")

        for filepath in filepaths:
            image = read_image(Path(filepath, "image.jpg"))
            depth = read_depth(Path(filepath, depth_filename))
            meta = read_json(Path(filepath, "meta.json"))
            depth_mask = np.isfinite(depth)
            intrinsics = np.array(meta["intrinsics"], np.float32)

            out = Path(output_folder or filepath)
            out.mkdir(parents=True, exist_ok=True)

            if save_depth_vis or not save_ply_:
                vis = colorize_depth(np.nan_to_num(depth, nan=0), mask=depth_mask)
                cv2.imwrite(str(out / "depth_vis.png"), cv2.cvtColor(vis, cv2.COLOR_RGB2BGR))

            if save_ply_:
                verts = unproject_cv_numpy(uv_map_numpy(*image.shape[:2]), np.nan_to_num(depth, nan=0), intrinsics)
                keep = depth_mask & (depth < depth[depth_mask].min() * max_depth)
                # OpenGL flip for viewers
                save_ply(out / "pointcloud.ply", verts[keep] * [1, -1, -1], np.zeros((0, 3), np.uint32),
                         image[keep].astype(np.float32) / 255)
            print(f"Visualized {filepath} -> {out}")

    return vis_data


def main():
    command()()


if __name__ == "__main__":
    main()
