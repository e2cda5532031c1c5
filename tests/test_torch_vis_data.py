"""The port's ``vis_data`` command (moge_tpu_torch.scripts.vis_data)
against the JAX package's on the CPU, over the synthetic training layout
(``write_train_dataset``: inf sky and NaN holes): the same files, byte for
byte (one cv2, one matplotlib), and a PLY holding one vertex per finite
depth pixel nearer than ``--max_depth`` times the nearest."""

import numpy as np
import pytest
from click.testing import CliRunner

from moge_tpu.scripts.vis_data import main as jax_vis_data
from moge_tpu_torch.scripts import cli
from moge_tpu_torch.utils.io import read_depth
from torch_tiny_config import write_train_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_train_dataset(tmp_path_factory.mktemp("vis"), n_instances=2, hw=(48, 64))[1]  # SynthB


def _ply_vertices(path):
    header = path.read_bytes().split(b"end_header\n")[0].decode()
    return int(header.split("element vertex ")[1].split()[0])


@pytest.mark.parametrize("flags", [["--ply"], ["--ply", "--depth_vis", "-m", "1.5"], []],
                         ids=["ply", "both", "default"])
def test_vis_data_equals_jax(dataset, tmp_path, flags):
    args = [dataset["path"], "--depth", dataset["depth"], *flags]
    got = CliRunner().invoke(cli.command(), ["vis_data", *args, "-o", str(tmp_path / "port")])
    want = CliRunner().invoke(jax_vis_data, [*args, "-o", str(tmp_path / "jax")])
    assert got.exit_code == 0 and want.exit_code == 0, (got.output, want.output)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted((["pointcloud.ply"] if "--ply" in flags else []) +
                           (["depth_vis.png"] if "--depth_vis" in flags or not flags else []))
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    if "--ply" in flags:
        # the output folder is shared, so the last instance's cloud is the one left
        depth = read_depth(f"{dataset['path']}/instance_1/{dataset['depth']}")
        finite = np.isfinite(depth)
        max_depth = float(flags[-1]) if "-m" in flags else np.inf
        want_n = int((finite & (depth < depth[finite].min() * max_depth)).sum())
        assert _ply_vertices(tmp_path / "port" / "pointcloud.ply") == want_n
