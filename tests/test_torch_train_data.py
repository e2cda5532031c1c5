"""The port's training loader (moge_tpu_torch.train.dataloader) against the
JAX package's, on the CPU, over synthetic datasets that carry
configs/train/v2.json's per-dataset options (``write_train_dataset``):
``_process_instance`` key by key for each option, the sampler's batches
(the port's explicit ``random.Random(s)`` against JAX's global ``random``
under ``random.seed(s)``, with the JAX train command's size quantisation),
and whole collated batches through both threaded pipelines. One cv2, one
Pillow and the same seeds: equal bit for bit."""

import copy
import json
import random
from pathlib import Path

import numpy as np
import pytest

from moge_tpu.train.dataloader import TrainDataLoaderPipeline as JaxLoader
from moge_tpu_torch.train.dataloader import TrainDataLoaderPipeline as TorchLoader
from torch_tiny_config import write_train_dataset

V2_DATA = json.loads((Path(__file__).resolve().parent.parent / "configs/train/v2.json").read_text())["data"]
QUANTUM = 32


@pytest.fixture(scope="module")
def data_config(tmp_path_factory):
    """v2.json's data section with the synthetic datasets and areas cut to
    4-16k pixels."""
    root = tmp_path_factory.mktemp("train_data")
    return {**copy.deepcopy(V2_DATA), "datasets": write_train_dataset(root, n_instances=3, hw=(96, 128)),
            "area_range": [4000, 16000]}


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    return a == b


def _instance(loader, dataset, filename, seed, hw=(64, 96)):
    inst = {"batch_id": 1, "seed": seed, "dataset": dataset, "filename": filename,
            "path": Path(loader.datasets[dataset]["path"], filename),
            "label_type": loader.datasets[dataset]["label_type"], "width": hw[1], "height": hw[0]}
    return loader._load_instance(inst)


# (dataset, instance, seed): A is metric (unit 1) with only_known, shot_noise and
# dof; B metric in mm; C not metric; instances 0 and 2 have an inf sky, 1 not;
# a missing instance becomes the invalid placeholder
CASES = [("SynthA", "instance_0", 1), ("SynthA", "instance_1", 2), ("SynthA", "instance_2", 11),
         ("SynthB", "instance_0", 3), ("SynthB", "instance_1", 4), ("SynthC", "instance_2", 5),
         ("SynthC", "instance_0", 6), ("SynthA", "missing", 7)]


@pytest.mark.parametrize("dataset,filename,seed", CASES)
def test_process_instance_equals_jax(data_config, dataset, filename, seed):
    jl, tl = JaxLoader(data_config, 2), TorchLoader(data_config, 2, random.Random(0))
    raw = _instance(jl, dataset, filename, seed)
    assert _equal(raw["image"], _instance(tl, dataset, filename, seed)["image"])
    want = jl._process_instance(copy.deepcopy(raw))
    got = tl._process_instance(copy.deepcopy(raw))
    assert set(got) == set(want)
    for k in want:
        assert _equal(got[k], want[k]), k
    assert got["label_type"] == ("invalid" if filename == "missing" else raw["label_type"])
    assert got["is_metric"] == ("depth_unit" in jl.datasets[dataset])
    assert np.isinf(raw["depth"]).any() == (filename in ("instance_0", "instance_2"))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("strategy", ["aspect_area", "fixed"])
def test_sampler_equals_jax(data_config, seed, strategy):
    """The first 8 batches: dataset, file, instance seed and size after the
    quantisation the JAX command patches into its sampler."""
    cfg = dict(data_config)
    if strategy == "fixed":
        cfg = {k: v for k, v in cfg.items() if k not in ("area_range", "aspect_ratio_range")}
        cfg["image_sizes"] = [[100, 70], [64, 130], [90, 90]]
    keys = ("batch_id", "dataset", "filename", "seed", "width", "height")
    saved = random.getstate()
    try:
        random.seed(seed)
        want = []
        for batch, _ in zip(JaxLoader(cfg, 3)._sample_batch(), range(8)):
            for inst in batch:
                inst["width"] = max(QUANTUM, inst["width"] // QUANTUM * QUANTUM)
                inst["height"] = max(QUANTUM, inst["height"] // QUANTUM * QUANTUM)
            want.append([tuple(inst[k] for k in keys) for inst in batch])
    finally:
        random.setstate(saved)
    got = [[tuple(inst[k] for k in keys) for inst in batch]
           for batch, _ in zip(TorchLoader(cfg, 3, random.Random(seed), QUANTUM)._sample_batch(), range(8))]
    assert got == want
    assert len({b[0][4:] for b in got}) > 1  # the size varies between batches


def test_collated_batches_equal_jax(data_config):
    """Two batches through each threaded pipeline: same keys, dtypes,
    shapes and values."""
    saved = random.getstate()
    try:
        random.seed(5)
        with JaxLoader(data_config, 2, num_load_workers=2, num_process_workers=2, buffer_size=2) as jl:
            want = [jl.get() for _ in range(2)]
    finally:
        random.setstate(saved)
    with TorchLoader(data_config, 2, random.Random(5), num_load_workers=2, num_process_workers=2,
                     buffer_size=2) as tl:
        got = [tl.get() for _ in range(2)]
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"image", "depth", "depth_mask_fin", "depth_mask_inf", "normal", "normal_mask",
                                    "intrinsics", "label_type", "is_metric", "info"}
        for k in w:
            assert _equal(g[k], w[k]), k
        assert g["image"].dtype == np.float32 and g["image"].ndim == 4 and g["image"].shape[-1] == 3
        assert g["depth_mask_fin"].dtype == bool and g["intrinsics"].shape == (2, 3, 3)
