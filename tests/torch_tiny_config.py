"""Tiny MoGe-2 config shared by the port's tests (no JAX import at module
level, so GPU hosts without JAX can use it): the full structure (encoder,
neck, three heads, scale MLP) on the ``dinov2_vitt14`` arch, as in
``__graft_entry__.dryrun_multichip``; the weight bridge from the JAX
package's parameter trees to the port's state dicts; a smooth distance
field seen by the panorama's views; and a synthetic eval benchmark and
synthetic training datasets written with the port's codecs."""

_HEAD = {
    "dim_in": [64, 32, 16, 16, 16], "dim_res_blocks": [64, 32, 16, 16, 16], "num_res_blocks": [0, 1, 1, 1, 0],
    "res_block_in_norm": "none", "res_block_hidden_norm": "none",
    "resamplers": ["conv_transpose", "conv_transpose", "conv_transpose", "bilinear"],
}

TINY_CONFIG = {
    "encoder": {"backbone": "dinov2_vitt14", "intermediate_layers": [0, 1, 2, 3], "dim_out": 64},
    "neck": {
        "dim_in": [66, 2, 2, 2, 2], "dim_out": None,
        "dim_res_blocks": [64, 32, 16, 16, 16], "num_res_blocks": [0, 1, 1, 1, 0],
        "res_block_in_norm": "none", "res_block_hidden_norm": "none",
        "resamplers": ["conv_transpose", "conv_transpose", "conv_transpose", "bilinear"],
    },
    "points_head": {**_HEAD, "dim_out": [None, None, None, None, 3]},
    "normal_head": {**_HEAD, "dim_out": [None, None, None, None, 3]},
    "mask_head": {**_HEAD, "dim_out": [None, None, None, None, 1]},
    "scale_head": {"dims": [192, 64, 1]},
    "remap_output": "exp",
    "num_tokens_range": [1200, 3600],
}


def make_points_perspective(module, z=0.3, tilt=0.5):
    """Set a MoGe-2 module's weights (in place) so that its raw point map is
    (u, v, z + tilt * u) over the view-plane UV: with the 'exp' remap, a
    surface seen through focal 1 with shift 0 whose depth varies across the
    image, so the focal/shift solve has one exact answer. The finest-level
    path from the neck's UV input to the points head's output becomes linear
    and the up2 convs feeding it are zeroed. Random weights give degenerate
    point maps (as does a constant depth: only focal over shift is fixed)
    whose solve turns 1e-7 changes of the raw maps (a batch's summation
    order) into any focal; this one is well conditioned, so comparisons after
    the solve test what they mean to."""
    import torch

    def eye_into(weight, n=2):
        weight.zero_()
        for i in range(n):
            weight[i, i, 0, 0] = 1.0

    with torch.no_grad():
        neck_in = module.neck.input_blocks[-1]
        neck_in.weight[:2] = 0.0
        neck_in.weight[0, 0, 0, 0] = neck_in.weight[1, 1, 0, 0] = 1.0
        neck_in.bias[:2] = 0.0
        for stack in (module.neck, module.points_head):
            stack.resamplers[-1][1].weight.zero_()
            stack.resamplers[-1][1].bias.zero_()
        eye_into(module.points_head.input_blocks[-1].weight)
        module.points_head.input_blocks[-1].bias.zero_()
        out = module.points_head.output_blocks[-1]
        eye_into(out.weight)
        out.weight[2, 0, 0, 0] = tilt
        out.bias.copy_(torch.tensor([0.0, 0.0, z]))
    return module


def make_points_perspective_v1(module, focal=1.5, z=0.3, tilt=0.5, mask=1.0):
    """MoGe-1's counterpart of ``make_points_perspective``: set a ``MoGeV1``
    module's two output blocks (in place) so that its raw point map is
    (u / focal, v / focal, z + tilt * u) over the view-plane UV and its raw
    mask is ``mask`` everywhere. With the 'exp' remap that is a surface seen
    through ``focal`` with shift 0 and depth exp(z + tilt * u): the
    focal/shift solve has one exact answer, and a focal other than 1 tells
    it from the solve's degenerate fallback (focal 1, shift 0). The points
    block's first conv reads the UV channels appended to its input (its
    last two) at the centre tap into channels u, -u, v, -v, which the
    block's ReLU keeps as their positive parts; its residual blocks, zeroed,
    pass them on; its last conv recombines them. Every other weight of both
    blocks is 0."""
    import torch

    points, mask_block = module.head.output_block
    conv_in, conv_out = points[0], points[-1]
    c = conv_in.weight.shape[1] - 2
    k = conv_out.weight.shape[-1] // 2  # the centre tap of a 1x1 or 3x3 output conv
    with torch.no_grad():
        for p in (*points.parameters(), *mask_block.parameters()):
            p.zero_()
        for ch, (src, sign) in enumerate(((c, 1.0), (c, -1.0), (c + 1, 1.0), (c + 1, -1.0))):
            conv_in.weight[ch, src, 1, 1] = sign
        w = conv_out.weight
        w[0, 0, k, k], w[0, 1, k, k] = 1.0 / focal, -1.0 / focal
        w[1, 2, k, k], w[1, 3, k, k] = 1.0 / focal, -1.0 / focal
        w[2, 0, k, k], w[2, 1, k, k] = tilt, -tilt
        conv_out.bias.copy_(torch.tensor([0.0, 0.0, z]))
        mask_block[-1].bias.fill_(mask)
    return module


def perspective_v1_answer(h, w, focal=1.5, z=0.3, tilt=0.5):
    """What ``infer`` should find for an (h, w) image on a module set by
    ``make_points_perspective_v1``: fx and fy of the intrinsics (normalised by
    the image width and height) and the depth map (h, w), exp(z + tilt * u)."""
    import torch

    from moge_tpu_torch.ops.geometry import normalized_view_plane_uv

    aspect = w / h
    fx = focal / 2 * (1 + aspect ** 2) ** 0.5 / aspect
    fy = focal / 2 * (1 + aspect ** 2) ** 0.5
    u = normalized_view_plane_uv(w, h, aspect)[..., 0]
    return fx, fy, torch.exp(z + tilt * u)


def _to_torch(sd):
    import numpy as np
    import torch

    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def state_dict_from_jax_params(config, params):
    """JAX MoGe-2 params (a nested dict of arrays, either DINOv2 block layout)
    -> the torch state dict the port loads strictly, written by the JAX
    package's own exporter, so that both packages compute with one set of
    weights."""
    from moge_tpu.models.convert import export_moge2

    return _to_torch(export_moge2(config, params)["model"])


def v1_state_dict_from_jax_params(config, params):
    """JAX MoGe-1 params -> the port's torch state dict (``export_moge1``)."""
    from moge_tpu.models.convert import export_moge1

    return _to_torch(export_moge1(config, params)["model"])


def smooth_distance(directions):
    """Smooth positive field on the sphere (tests/test_panorama.py's)."""
    import numpy as np

    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    return 2.0 + 0.5 * z + 0.3 * np.sin(2 * x) * np.cos(y)


def smooth_field_views(res=48, knock_out=False):
    """Distance maps (12, res, res) float32 of ``smooth_distance`` as the
    panorama's 12 views see it, and their masks (12, res, res) bool, every
    third view with a block knocked out when ``knock_out``
    (tests/test_panorama.py's inputs; the block scaled with ``res``)."""
    import numpy as np

    from moge_tpu_torch.panorama import _unproject, get_panorama_cameras
    from moge_tpu_torch.utils.geometry_numpy import uv_map_numpy

    uv = uv_map_numpy(res, res)
    distance_maps, masks = [], []
    for vi, (E, K) in enumerate(zip(*get_panorama_cameras())):
        d = _unproject(uv, E, K)
        distance_maps.append(smooth_distance(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
        m = np.ones((res, res), bool)
        if knock_out and vi % 3 == 0:
            m[res // 6:res * 5 // 12, res * 5 // 24:res * 5 // 8] = False
        masks.append(m)
    return np.stack(distance_maps), np.stack(masks)


def write_benchmark(root, n_samples=3, hw=(60, 80), seed=0):
    """A synthetic eval benchmark under ``root``, as
    ``tests/test_eval_e2e.py::_write_benchmark`` writes it but with the
    port's codecs (``moge_tpu_torch.utils.io``): per sample ``image.jpg``
    (uniform noise), a log-PNG ``depth.png`` (a smooth 2..6 m ramp; sample 0
    with a 5x5 corner of inf, the sky), ``meta.json`` (fx = 1), and for
    sample 1 a ``segmentation.png`` with labels wall / floor / sky; then
    ``.index.txt``. Returns the sample names."""
    from pathlib import Path

    import numpy as np

    from moge_tpu_torch.utils.io import write_depth, write_image, write_json, write_segmentation

    root = Path(root)
    rng = np.random.default_rng(seed)
    h, w = hw
    names = []
    for i in range(n_samples):
        d = root / f"sample_{i}"
        d.mkdir(parents=True)
        write_image(d / "image.jpg", rng.uniform(0, 255, (h, w, 3)).astype(np.uint8))
        yy, xx = np.mgrid[0:h, 0:w]
        depth = (2.0 + 3.0 * yy / h + 0.5 * np.sin(xx * 80 / (7.0 * w))).astype(np.float32)
        if i == 0:
            depth[:5, :5] = np.inf
        write_depth(d / "depth.png", depth)
        write_json(d / "meta.json", {"intrinsics": [[1.0, 0.0, 0.5], [0.0, w / h, 0.5], [0.0, 0.0, 1.0]]})
        if i == 1:
            seg = np.zeros((h, w), np.uint16)
            seg[:, w // 2:] = 1
            seg[: h // 6, : w // 8] = 2
            write_segmentation(d / "segmentation.png", seg, {"wall": 0, "floor": 1, "sky": 2})
        names.append(d.name)
    (root / ".index.txt").write_text("\n".join(names))
    return names


# the per-dataset keys of configs/train/v2.json that the synthetic training
# datasets carry: label types A, B and C, metric (depth_unit 1 and 0.001) and
# not, the relative fov range, the dof and shot_noise augmentations, the
# only_known finite mask and the completed-depth file name
TRAIN_DATASETS = [
    {"name": "SynthA", "label_type": "A", "weight": 5.0, "depth_unit": 1, "fov_range_relative": [0.5, 1.0],
     "image_augmentation": ["jittering", "jpeg_loss", "blurring", "shot_noise", "dof"],
     "finite_depth_mask": "only_known"},
    {"name": "SynthB", "label_type": "B", "weight": 8.6, "depth_unit": 0.001, "fov_range_relative": [0.5, 1.0],
     "image_augmentation": ["jittering", "jpeg_loss", "blurring", "dof"], "depth": "depth_completed.png"},
    {"name": "SynthC", "label_type": "C", "weight": 5.6, "fov_range_relative": [0.5, 1.0],
     "image_augmentation": ["jittering", "jpeg_loss", "blurring", "dof"], "depth": "depth_completed.png"},
]


def write_train_dataset(root, n_instances=3, hw=(96, 128), seed=0):
    """Synthetic training datasets under ``root`` in the layout the training
    loader reads, written with the port's codecs: one folder per entry of
    ``TRAIN_DATASETS``, each with ``n_instances`` instance folders
    (``image.jpg``, a smooth image with noise; the depth PNG under the
    entry's ``depth`` name, a tilted wavy surface in the entry's unit, with
    an inf sky over the top rows of every other instance and a NaN hole;
    ``meta.json`` with normalised intrinsics of a 50-70 degree horizontal
    fov) and ``.index.txt``. Returns ``TRAIN_DATASETS`` with each entry's
    ``path`` set, for a config's ``data.datasets``."""
    import copy
    from pathlib import Path

    import numpy as np

    from moge_tpu_torch.utils.io import write_depth, write_image, write_json

    root = Path(root)
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    datasets = copy.deepcopy(TRAIN_DATASETS)
    for ds in datasets:
        folder = root / ds["name"]
        names = []
        for i in range(n_instances):
            d = folder / f"instance_{i}"
            d.mkdir(parents=True)
            phase = rng.uniform(0, 6, 3)
            base = 127 + 80 * np.sin(4 * xx[..., None] + 3 * yy[..., None] + phase)
            image = np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
            write_image(d / "image.jpg", image)
            depth = 2.0 + 1.5 * yy + 0.3 * np.sin(9 * xx + phase[0]) + 0.05 * rng.standard_normal((h, w))
            depth = (depth / ds.get("depth_unit", 1)).astype(np.float32)
            if i % 2 == 0:
                depth[: h // 8] = np.inf
            r, c = rng.integers(h // 4, h // 2), rng.integers(w // 4, w // 2)
            depth[r:r + h // 10, c:c + w // 10] = np.nan
            write_depth(d / ds.get("depth", "depth.png"), depth)
            fx = 0.5 / np.tan(np.deg2rad(rng.uniform(50, 70)) / 2)
            write_json(d / "meta.json", {"intrinsics": [[fx, 0.0, 0.5], [0.0, fx * w / h, 0.5], [0.0, 0.0, 1.0]]})
            names.append(d.name)
        (folder / ".index.txt").write_text("\n".join(names))
        ds["path"] = str(folder)
    return datasets


def whole_train_state(state, gen):
    """A train state with every sharded tensor gathered whole (a collective:
    under FSDP every rank calls), on the CPU: {'tensors': by name, the
    module's state dict as 'model.*', AdamW's moments and steps as
    'adamw.<index>.*', the EMA as 'ema.*'; 'scalars': step, update count,
    learning rates, generator state}."""
    from moge_tpu_torch.parallel.mesh import whole

    named = {f"model.{k}": v for k, v in state.module.state_dict().items()}
    for i, per in state.optimizer.adamw.state_dict()["state"].items():
        named.update({f"adamw.{i}.{k}": v for k, v in per.items()})
    named.update({f"ema.{k}": v for k, v in (state.ema_params or {}).items()})
    scalars = {"step": state.step, "count": state.optimizer.count, "lrs": state.optimizer.lrs(),
               "gen": gen.get_state().tolist()}
    return {"tensors": {k: whole(v).detach().cpu().clone() for k, v in named.items()}, "scalars": scalars}


def run_train_rank(train_args, rank, world, rendezvous, device="cpu", backend="gloo"):
    """One rank of a multi-process ``train`` run in this process: joins a
    ``backend`` process group of ``world`` at ``rendezvous`` (a ``file://`` URL),
    runs ``cli train --multihost`` on ``device`` with ``train_args``, and
    returns (the command's result, ``whole_train_state`` of its state). The
    group outlives the command (it keeps a group it did not make) for the
    gathers, then ends."""
    import torch.distributed as dist

    from moge_tpu_torch.parallel.distributed import initialize_distributed
    from moge_tpu_torch.scripts import cli

    initialize_distributed(rendezvous, world, rank, backend)
    try:
        args = ["train", *train_args, "--multihost", "--coordinator", rendezvous, "--num_processes", str(world),
                "--process_id", str(rank), "--device", device]
        result = cli.command().main(args, standalone_mode=False)
        return result, whole_train_state(result["state"], result["gen"])
    finally:
        dist.destroy_process_group()


def train_rank_main():
    """``python -c`` entry of one rank for the tests: argv is <out file>
    <rank> <world> <rendezvous> <compute dtype> <train args...>; writes
    {'state', 'steps'} to the out file with ``torch.save``."""
    import sys

    import torch

    from moge_tpu_torch.scripts import train

    torch.set_num_threads(1)
    out, rank, world, rendezvous, dtype, *train_args = sys.argv[1:]
    train.COMPUTE_DTYPE = getattr(torch, dtype)
    result, whole = run_train_rank(train_args, int(rank), int(world), rendezvous)
    torch.save({"state": whole, "steps": result["steps"]}, out)
