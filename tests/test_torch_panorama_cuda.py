"""The panorama split and the CG merge, and the eval metrics' alignment
solves, on the card against the same functions on the CPU. Needs a CUDA GPU
(the split, merge and solves are plain torch there: this holds the card's
run of the two slices' host paths); skipped elsewhere. On a GPU host:

    python -m pytest --noconftest -m cuda tests/test_torch_panorama_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX, which a GPU host need
not have. This file imports no JAX.)
"""

import numpy as np
import pytest
import torch

from moge_tpu_torch import panorama as pano
from torch_tiny_config import smooth_field_views, write_benchmark

pytestmark = pytest.mark.cuda

CG_RTOL = 1e-4       # 300 fp32 CG iterations whose dot products sum in another order
METRIC_RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: these run the card's side of the panorama and eval paths")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_split_on_the_card_matches_the_cpu(dev, dtype):
    extrinsics, intrinsics = pano.get_panorama_cameras()
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.uniform(0, 255, (240, 480, 3)).astype(np.float32)).to(dtype)
    cpu = pano.split_panorama_image(image, extrinsics, intrinsics, 128)
    card = pano.split_panorama_image(image.to(dev), extrinsics, intrinsics, 128)
    assert card.device.type == "cuda" and card.dtype == dtype
    diff = (card.cpu().float() - cpu.float()).abs().max().item()
    assert diff <= (1 if dtype == torch.uint8 else 1e-4), diff


def test_cg_merge_on_the_card_matches_the_cpu(dev):
    extrinsics, intrinsics = pano.get_panorama_cameras()
    maps, masks = (torch.from_numpy(a) for a in smooth_field_views(64, knock_out=True))
    cpu, cpu_mask = pano.merge_panorama_depth(512, 256, maps, masks, extrinsics, intrinsics, solver="cg")
    card, card_mask = pano.merge_panorama_depth(512, 256, maps.to(dev), masks.to(dev), extrinsics, intrinsics,
                                                solver="cg")
    assert card.device.type == "cuda"
    assert torch.equal(card_mask.cpu(), cpu_mask)
    rel = ((card.cpu() - cpu).abs() / cpu).max().item()
    assert rel <= CG_RTOL, rel


def test_compute_metrics_on_the_card_matches_the_cpu(dev, tmp_path):
    from moge_tpu_torch.eval import metrics
    from moge_tpu_torch.eval.dataloader import EvalDataLoaderPipeline

    write_benchmark(tmp_path, n_samples=2)
    with EvalDataLoaderPipeline(str(tmp_path), 80, 60, depth_unit=1.0, has_sharp_boundary=True,
                                include_segmentation=True, min_seg_area=100, num_load_workers=1,
                                num_process_workers=1) as pipe:
        gt = [pipe.get() for _ in range(len(pipe))][1]
    rng = np.random.default_rng(1)
    pred = {"depth_metric": gt["depth"] * rng.uniform(0.9, 1.1, gt["depth"].shape).astype(np.float32),
            "points_metric": gt["points"] * 1.05 + rng.normal(0, 0.01, gt["points"].shape).astype(np.float32),
            "intrinsics": gt["intrinsics"]}
    metrics.SOLVES.clear()
    card, _ = metrics.compute_metrics(pred, gt, device=dev)
    assert set(metrics.SOLVES) == {"cuda"}
    cpu, _ = metrics.compute_metrics(pred, gt, device="cpu")
    assert card.keys() == cpu.keys() and "local_points" in card
    for family in cpu:
        for key, value in cpu[family].items():
            if family == "boundary":  # computed from the prediction itself, not a solve
                assert card[family][key] == value, (family, key)
            else:
                np.testing.assert_allclose(card[family][key], value, rtol=METRIC_RTOL, err_msg=f"{family}.{key}")
