"""The port's inference CLI (moge_tpu_torch.scripts.infer, grouped in
moge_tpu_torch.scripts.cli) through click's CliRunner on the CPU: tiny
MoGe-2 and MoGe-1 checkpoints written as reference-format ``.pt`` files,
the maps and fov.json it writes, the panorama command, the export command,
and the command group with its refusal of a missing card."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from moge_tpu_torch.models import import_model_class_by_version
from moge_tpu_torch.models.v1 import MoGeModel as MoGeV1Model
from moge_tpu_torch.models.v2 import MoGeModel
from moge_tpu_torch.models.export import export_program, load_program
from moge_tpu_torch.scripts import cli, infer, infer_panorama
from torch_tiny_config import TINY_CONFIG, make_points_perspective

ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)

TINY_V1 = {"encoder": "dinov2_vitt14", "intermediate_layers": 4, "dim_proj": 32, "dim_upsample": [32, 16, 16],
           "dim_times_res_block_hidden": 2, "num_res_blocks": 1, "remap_output": "exp",
           "res_block_norm": "group_norm", "last_res_blocks": 1, "last_conv_channels": 32, "last_conv_size": 1}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    v2 = MoGeModel(TINY_CONFIG, "cpu", torch.float32).init_random(seed=0)
    make_points_perspective(v2.module)
    v1 = MoGeV1Model(TINY_V1, "cpu", torch.float32).init_random(seed=0)
    paths = {}
    for name, model, cfg in (("v2", v2, TINY_CONFIG), ("v1", v1, TINY_V1)):
        paths[name] = root / f"{name}.pt"
        torch.save({"model_config": cfg, "model": model.module.state_dict()}, paths[name])
    return paths


def _write_image(path, h, w, seed):
    import cv2

    image = np.random.default_rng(seed).uniform(0, 255, (h, w, 3)).astype(np.uint8)
    cv2.imwrite(str(path), image)
    return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("version,num_tokens", [("v2", 16), ("v1", 64)])
def test_infer_cli_writes_the_maps(checkpoints, tmp_path, version, num_tokens):
    from click.testing import CliRunner

    from moge_tpu.utils.io import read_exr

    image = _write_image(tmp_path / "scene.png", 70, 84, seed=1)
    out_dir = tmp_path / "out"
    result = CliRunner().invoke(infer.command(), [
        "-i", str(tmp_path / "scene.png"), "-o", str(out_dir), "--pretrained", str(checkpoints[version]),
        "--version", version, "--device", "cpu", "--num_tokens", str(num_tokens), "--maps"])
    assert result.exit_code == 0, result.output
    save = out_dir / "scene"
    for name in ("depth.exr", "points.exr", "mask.png", "fov.json", "image.jpg", "depth_vis.png"):
        assert (save / name).is_file(), name
    assert (save / "normal.png").is_file() == (version == "v2")

    model = import_model_class_by_version(version).from_pretrained(checkpoints[version], device="cpu",
                                                                   dtype=torch.float32)
    want = model.infer(torch.from_numpy(image.astype(np.float32) / 255.0), num_tokens=num_tokens)
    depth = read_exr(save / "depth.exr")
    assert depth.shape == (70, 84)
    np.testing.assert_array_equal(np.isfinite(depth), np.isfinite(want["depth"].numpy()))
    fin = np.isfinite(depth)
    np.testing.assert_allclose(depth[fin], want["depth"].numpy()[fin], rtol=1e-5)
    assert read_exr(save / "points.exr").shape == (70, 84, 3)
    fov = json.loads((save / "fov.json").read_text())
    fx = want["intrinsics"][0, 0].item()
    assert fov["fov_x"] == round(float(np.rad2deg(2 * np.arctan(0.5 / fx))), 2)


def test_infer_cli_exports_meshes(checkpoints, tmp_path):
    from click.testing import CliRunner

    _write_image(tmp_path / "scene.png", 56, 56, seed=2)
    result = CliRunner().invoke(infer.command(), [
        "-i", str(tmp_path), "-o", str(tmp_path / "out"), "--pretrained", str(checkpoints["v2"]),
        "--device", "cpu", "--num_tokens", "16", "--glb", "--ply", "--fov_x", "60"])
    assert result.exit_code == 0, result.output
    assert (tmp_path / "out" / "scene" / "mesh.glb").is_file()
    assert (tmp_path / "out" / "scene" / "pointcloud.ply").is_file()


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_infer_cli_accepts_show_and_warns(checkpoints, tmp_path, version):
    """``--show`` (the reference's viewer) is accepted, warns once that the
    command is headless, and the maps are written as without it."""
    from click.testing import CliRunner

    _write_image(tmp_path / "scene.png", 56, 70, seed=2)
    with pytest.warns(UserWarning, match="headless"):
        result = CliRunner().invoke(infer.command(), [
            "-i", str(tmp_path / "scene.png"), "-o", str(tmp_path / "out"), "--pretrained", str(checkpoints[version]),
            "--version", version, "--device", "cpu", "--num_tokens", "16", "--maps", "--show"])
    assert result.exit_code == 0, result.output
    for name in ("depth.exr", "points.exr", "mask.png", "fov.json"):
        assert (tmp_path / "out" / "scene" / name).is_file(), name


def test_infer_cli_refuses_a_missing_card(checkpoints, tmp_path):
    from click.testing import CliRunner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _write_image(tmp_path / "scene.png", 56, 56, seed=3)
    result = CliRunner().invoke(infer.command(), ["-i", str(tmp_path / "scene.png"),
                                                  "--pretrained", str(checkpoints["v2"])])
    assert result.exit_code == 2 and "no CUDA device" in result.output


def test_cli_group_offers_the_ported_commands():
    from click.testing import CliRunner

    group = cli.command()
    assert set(group.commands) == {"infer", "serve", "infer_panorama", "eval_baseline", "infer_baseline", "train",
                                   "vis_data", "export_program"}
    result = CliRunner().invoke(group, ["--help"])
    assert result.exit_code == 0 and all(name in result.output for name in group.commands)


@pytest.mark.parametrize("name", ["infer_panorama", "eval_baseline", "infer_baseline", "export_program"])
def test_new_commands_refuse_a_missing_card(checkpoints, tmp_path, name):
    """``--device cuda`` (the default) without a card is refused up front:
    by the command, or by the port's MoGe adapter the eval commands load."""
    from click.testing import CliRunner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _write_image(tmp_path / "scene.png", 56, 56, seed=3)
    adapter = str(ROOT / "moge_tpu_torch" / "baselines" / "moge.py")
    config = tmp_path / "config.json"
    config.write_text(json.dumps({}))
    args = {"infer_panorama": ["-i", str(tmp_path / "scene.png"), "--pretrained", str(checkpoints["v2"]),
                               "--device", "cuda"],
            "eval_baseline": ["--baseline", adapter, "--config", str(config), "-o", str(tmp_path / "r.json"),
                              "--pretrained", str(checkpoints["v2"]), "--device", "cuda"],
            "infer_baseline": ["--baseline", adapter, "-i", str(tmp_path / "scene.png"), "--pretrained",
                               str(checkpoints["v2"]), "--device", "cuda"],
            "export_program": ["--pretrained", str(checkpoints["v2"]), "-o", str(tmp_path / "m.pt2")]}[name]
    result = CliRunner().invoke(cli.command(), [name, *args])
    assert result.exit_code == 2 and "no CUDA device" in result.output, result.output


@pytest.mark.parametrize("post", [False, True], ids=["raw", "with_postprocess"])
def test_export_program_cli_writes_the_artifact(checkpoints, tmp_path, post):
    """The command's artifact (the checkpoint loaded in bf16, as the JAX
    command loads it) gives the outputs of ``export_program``'s on the same
    model, and its summary line names the form, shape and size."""
    from click.testing import CliRunner

    args = ["export_program", "--pretrained", str(checkpoints["v2"]), "-o", str(tmp_path / "m.pt2"),
            "--height", "56", "--width", "70", "--num_tokens", "16", "--device", "cpu"]
    result = CliRunner().invoke(cli.command(), args + (["--with_postprocess"] if post else []))
    assert result.exit_code == 0, result.output
    blob = (tmp_path / "m.pt2").read_bytes()
    kind = "infer (with camera recovery)" if post else "raw forward"
    assert result.output.strip() == (f"wrote {tmp_path / 'm.pt2'} ({kind}, 1x56x70, 16 tokens, "
                                     f"{len(blob) / 1e6:.1f} MB)")
    model = MoGeModel.from_pretrained(checkpoints["v2"], device="cpu", dtype=torch.bfloat16)
    image = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (1, 56, 70, 3)).astype(np.float32))
    got = load_program(blob)(image)
    want = load_program(export_program(model, 56, 70, 16, with_postprocess=post))(image)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_infer_panorama_cli_writes_the_maps_and_warns_on_show(tmp_path):
    """The panorama command on a tiny MoGe-2 with few tokens: the maps and
    meshes it writes, the depth equal to ``infer_panorama``'s, and ``--show``
    accepted with the headless warning."""
    from click.testing import CliRunner

    from moge_tpu.utils.io import read_exr

    config = dict(TINY_CONFIG, num_tokens_range=[16, 36])
    model = MoGeModel(config, "cpu", torch.float32).init_random(seed=0)
    make_points_perspective(model.module)
    torch.save({"model_config": config, "model": model.module.state_dict()}, tmp_path / "model.pt")
    # the oracle computes in the command's default dtype, bf16, as the JAX command does
    model = MoGeModel.from_pretrained(tmp_path / "model.pt", device="cpu", dtype=torch.bfloat16)
    image = _write_image(tmp_path / "pano.png", 64, 128, seed=5)
    with pytest.warns(UserWarning, match="headless"):
        result = CliRunner().invoke(infer_panorama.command(), [
            "-i", str(tmp_path / "pano.png"), "-o", str(tmp_path / "out"), "--pretrained", str(tmp_path / "model.pt"),
            "--version", "v2", "--device", "cpu", "--merge_solver", "cg", "--maps", "--ply", "--show"])
    assert result.exit_code == 0, result.output
    save = tmp_path / "out" / "pano"
    for name in ("image.jpg", "depth_vis.png", "depth.exr", "points.exr", "mask.png", "mesh.ply"):
        assert (save / name).is_file(), name
    want = infer_panorama.infer_panorama(model, image, merge_solver="cg")
    np.testing.assert_allclose(read_exr(save / "depth.exr"), want["depth"].numpy(), rtol=1e-6)
    assert read_exr(save / "points.exr").shape == (64, 128, 3)


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_infer_panorama_computes_in_the_jax_commands_dtype(checkpoints, tmp_path, monkeypatch, version):
    """Under default flags the panorama command's model computes in the dtype
    of JAX's ``from_pretrained``, which its command loads through (bf16),
    and ``--fp16`` keeps it."""
    import inspect

    from click.testing import CliRunner

    from moge_tpu.models.v1 import MoGeModel as JaxV1
    from moge_tpu.models.v2 import MoGeModel as JaxV2

    jax_cls = {"v1": JaxV1, "v2": JaxV2}[version]
    want = getattr(torch, np.dtype(inspect.signature(jax_cls.from_pretrained).parameters["dtype"].default).name)
    seen = []

    def record(model, image, **kwargs):
        seen.append(model.dtype)
        h, w = image.shape[:2]
        return {"depth": torch.ones(h, w), "mask": torch.ones(h, w, dtype=torch.bool), "points": torch.ones(h, w, 3)}

    monkeypatch.setattr(infer_panorama, "infer_panorama", record)
    _write_image(tmp_path / "pano.png", 32, 64, seed=6)
    for extra in ([], ["--fp16"]):
        result = CliRunner().invoke(infer_panorama.command(), [
            "-i", str(tmp_path / "pano.png"), "-o", str(tmp_path / "out"), "--pretrained", str(checkpoints[version]),
            "--version", version, "--device", "cpu", "--maps", *extra])
        assert result.exit_code == 0, result.output
    assert seen == [want, want] and want == torch.bfloat16


def test_eval_baseline_oracle_and_dumps(checkpoints, tmp_path):
    """``eval_baseline`` through the port's adapter on the CPU: ``--oracle``
    hands the adapter the ground-truth intrinsics, so the field of view is
    the ground truth's; ``--dump_pred``/``--dump_gt`` write the sample's maps
    and metrics beside the result."""
    from click.testing import CliRunner

    from torch_tiny_config import write_benchmark

    write_benchmark(tmp_path / "data", n_samples=1)
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"synthetic": {"path": str(tmp_path / "data"), "width": 80, "height": 60,
                                                "depth_unit": 1.0, "num_load_workers": 1, "num_process_workers": 1}}))
    result = CliRunner().invoke(cli.command(), [
        "eval_baseline", "--baseline", str(ROOT / "moge_tpu_torch" / "baselines" / "moge.py"), "--config",
        str(config), "--output", str(tmp_path / "oracle.json"), "--oracle", "--dump_pred", "--dump_gt",
        "--pretrained", str(checkpoints["v2"]), "--num_tokens", "64", "--device", "cpu"])
    assert result.exit_code == 0, result.output
    assert json.loads((tmp_path / "oracle.json").read_text())["synthetic"]["fov_x"]["mae"] < 1e-3  # degrees
    dump = tmp_path / "oracle_dump" / "synthetic" / "sample_0"
    for name in ("pred/image.jpg", "pred/depth.png", "pred/metrics.json", "pred/fov.json", "gt/depth.png"):
        assert (dump / name).is_file(), name
