"""The port's whole eval run (``scripts.eval_baseline`` through the port's
MoGe adapter ``moge_tpu_torch/baselines/moge.py``) against the JAX run
(``moge_tpu.scripts.eval_baseline`` through the repo's ``baselines/moge.py``)
on a 2-sample synthetic benchmark with the same tiny MoGe-2 weights, both on
the CPU; and ``infer_baseline`` through the port's adapter."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moge_tpu.models.v2 import MoGeModel as JaxMoGeModel
from moge_tpu_torch.models.v2 import MoGeModel
from moge_tpu_torch.scripts import eval_baseline, infer_baseline
from moge_tpu_torch.utils.tools import flatten_nested_dict
from torch_tiny_config import TINY_CONFIG, make_points_perspective, state_dict_from_jax_params, write_benchmark

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RUN_RTOL = 1e-4  # every averaged metric: the models' fp32 outputs agree to ~1e-6, the solves to ~3e-5
NUM_TOKENS = "64"


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny MoGe-2 ``.pt`` both packages load: JAX's random weights through
    the weight bridge, the points head set to a known perspective so that
    the focal/shift solve is well conditioned."""
    jm = JaxMoGeModel(TINY_CONFIG, None, dtype=jnp.float32).init_random(seed=0, image_hw=(56, 56))
    model = MoGeModel(TINY_CONFIG, "cpu", torch.float32)
    model.module.load_state_dict(state_dict_from_jax_params(TINY_CONFIG, jax.tree.map(np.asarray, jm.params)))
    make_points_perspective(model.module)
    path = tmp_path_factory.mktemp("ckpt") / "model.pt"
    torch.save({"model_config": TINY_CONFIG, "model": model.module.state_dict()}, path)
    return path


@pytest.fixture(scope="module")
def bench_config(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    write_benchmark(root / "data", n_samples=2)
    config = root / "config.json"
    config.write_text(json.dumps({"synthetic": {
        "path": str(root / "data"), "width": 80, "height": 60, "depth_unit": 1.0, "has_sharp_boundary": True,
        "num_load_workers": 1, "num_process_workers": 1}}))
    return config


def test_eval_baseline_matches_jax(checkpoint, bench_config, tmp_path):
    from click.testing import CliRunner

    from moge_tpu.scripts.eval_baseline import main as jax_eval

    jax_eval.main(["--baseline", str(ROOT / "baselines" / "moge.py"), "--config", str(bench_config),
                   "--output", str(tmp_path / "jax.json"), "--pretrained", str(checkpoint),
                   "--num_tokens", NUM_TOKENS, "--version", "v2"], standalone_mode=False)
    result = CliRunner().invoke(eval_baseline.command(), [
        "--baseline", str(ROOT / "moge_tpu_torch" / "baselines" / "moge.py"), "--config", str(bench_config),
        "--output", str(tmp_path / "port.json"), "--pretrained", str(checkpoint),
        "--num_tokens", NUM_TOKENS, "--version", "v2", "--device", "cpu"])
    assert result.exit_code == 0, result.output
    want = flatten_nested_dict(json.loads((tmp_path / "jax.json").read_text()))
    got = flatten_nested_dict(json.loads((tmp_path / "port.json").read_text()))
    assert got.keys() == want.keys()
    families = {key[1] for key in got if key[0] == "synthetic"}
    assert {"depth_metric", "depth_scale_invariant", "depth_affine_invariant", "disparity_affine_invariant",
            "points_metric", "points_scale_invariant", "points_affine_invariant", "fov_x", "boundary"} <= families
    for key, value in want.items():
        if key[-1] == "inference_time":
            assert got[key] > 0
            continue
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], value, rtol=RUN_RTOL, atol=1e-7, err_msg=str(key))


def test_infer_baseline_writes_the_maps(checkpoint, tmp_path):
    import cv2
    from click.testing import CliRunner

    from moge_tpu.utils.io import read_exr

    image = np.random.default_rng(4).uniform(0, 255, (56, 70, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "scene.png"), image)
    result = CliRunner().invoke(infer_baseline.command(), [
        "--baseline", str(ROOT / "moge_tpu_torch" / "baselines" / "moge.py"), "-i", str(tmp_path / "scene.png"),
        "-o", str(tmp_path / "out"), "--maps", "--ply", "--pretrained", str(checkpoint), "--num_tokens", NUM_TOKENS,
        "--device", "cpu"])
    assert result.exit_code == 0, result.output
    save = tmp_path / "out" / "scene"
    for name in ("image.jpg", "points.exr", "depth.exr", "depth_vis.png", "mesh.ply"):
        assert (save / name).is_file(), name
    model = MoGeModel.from_pretrained(checkpoint, device="cpu", dtype=torch.float32)
    want = model.infer(torch.from_numpy(cv2.cvtColor(image, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0),
                       num_tokens=int(NUM_TOKENS))["depth"].numpy()
    depth = read_exr(save / "depth.exr")
    np.testing.assert_array_equal(np.isfinite(depth), np.isfinite(want))
    np.testing.assert_allclose(depth[np.isfinite(depth)], want[np.isfinite(want)], rtol=1e-5)

