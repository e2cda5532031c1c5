"""The yardstick's counts against hand-worked values, and the 3x3 convs
it counts against the ones the program runs."""

import pytest
import torch

import moge_tpu_torch.models.modules as modules
from port_bench import harness, program, roofline, weights
from port_bench.reference import models, vit
from port_bench.tests import tiny


def test_attention_forward_counts():
    # B=8, H=16, N = 52 x 69 tokens + cls = 3589, head 64, bf16
    flops, nbytes = roofline.attention_fwd(8, 16, 3589, 64, "bfloat16")
    assert flops == 422_082_019_328  # 4 B H N^2 d
    assert nbytes == 235_208_704  # q, k, v read and o written: 4 B N H d x 2 bytes


def test_conv3x3_counts():
    conv = {"B": 8, "H": 104, "W": 138, "C": 256, "O": 256, "residual": False}
    flops, nbytes = roofline.conv3x3(conv, "bfloat16")
    assert flops == 135_442_464_768  # 2 x 9 C O B H W
    assert nbytes == 118_751_232  # input + 3x3 weights + output, bf16
    flops32, nbytes32 = roofline.conv3x3(dict(conv, residual=True), "float32")
    assert flops32 == flops and nbytes32 == (2 * 29_392_896 + 589_824 + 29_392_896) * 4


def test_vit_l_forward_counts():
    # 37 x 37 tokens + cls, 24 blocks of D = 1024: 24 N D^2 + 4 N^2 D a block, and the patch embed
    assert roofline.vit_flops("dinov2_vitl14", 1, 1369) == 1_013_607_653_376


def test_giant_forward_counts():
    # 37 x 37 tokens + cls, 40 blocks of D = 1536 with the fused SwiGLU of hidden 4096:
    # 2 N (4 D^2 + 3 D 4096) + 4 N^2 D a block, and the patch embed
    assert roofline.vit_flops("dinov2_vitg14", 1, 1369) == 3_566_685_917_184


# (model_flops, k2_least_s, k3_least_s) at each cell's shape, held fixed: a change to the counts would move
# what the cells' mfu and roofline metrics read
CELL_COUNTS = {
    "v2l-serve-518-poisson": (11131161755648.0, 0.0014924714062689586, 0.002543753697618279),
    "v2l-offline-b8-3600": (35427068166144.0, 0.010242637476109201, 0.0066663982570496355),
    "v1l-folder-fp32-480x640": (2442620719104.0, 0.008833504499540864, 0.005223446280991736),
}


@pytest.mark.parametrize("cell", sorted(CELL_COUNTS))
def test_the_cells_counts_are_unchanged(cell):
    _, w, config = harness.load_cell(harness.ROOT, cell)
    cfg = config["model_config"]
    tokens = w.get("num_tokens") or models.num_tokens_of(cfg, w["resolution_level"])
    args = (config["version"], cfg, w.get("batch", w.get("max_batch")), w["height"], w["width"], tokens)
    got = (roofline.model_flops(*args), roofline.k2_least_s(*args, config["dtype"]),
           roofline.k3_least_s(*args, config["dtype"]))
    assert got == CELL_COUNTS[cell]


def test_the_roofline_reads_the_references_architectures():
    assert not hasattr(roofline, "VIT") and roofline.ARCHS is vit.ARCHS


def test_least_time_takes_the_larger_bound():
    assert roofline.least_s(989e12, 0.0, "bfloat16") == pytest.approx(1.0)
    assert roofline.least_s(0.0, 3.35e12, "float32") == pytest.approx(1.0)
    assert roofline.PEAK_FLOPS["float32"] == pytest.approx(66.9e12, rel=1e-3)


def test_the_published_decoders_have_the_programs_3x3_conv_counts():
    v2 = roofline.k3_convs("v2", program_config("moge-2-vitl-normal"), 8, 480, 640, 3600)
    v1 = roofline.k3_convs("v1", program_config("moge-vitl"), 1, 480, 640, 2500)
    assert len(v2) == 46 and len(v1) == 17  # the K3 launches a forward makes on the card


def program_config(name):
    from moge_tpu_torch.models import presets

    return presets.get_preset(name)["config"]


@pytest.mark.parametrize("cell", ["v2l-offline-b8-3600", "v1l-folder-fp32-480x640"])
def test_counted_convs_are_the_ones_the_program_runs(cell, monkeypatch):
    _, workload, config = tiny.cell(cell)
    sd = weights.draw(config["version"], config["model_config"], config["weights"], 3, "cpu")
    model = program.build(config, sd, "cpu")
    seen = []
    original = modules.conv3x3_replicate

    def record(x, kernel, bias, residual=None, input_relu=False):
        seen.append((x.shape[0], x.shape[1], x.shape[2], kernel.shape[-2], kernel.shape[-1], residual is not None))
        return original(x, kernel, bias, residual, input_relu)

    monkeypatch.setattr(modules, "conv3x3_replicate", record)
    model.infer(torch.rand(2, 60, 80, 3), num_tokens=36, use_fp16=False)
    counted = []
    for c in roofline.k3_convs(config["version"], config["model_config"], 2, 60, 80, 36):
        if c.get("up2"):  # run as one conv at half the size with 4 x O parity outputs
            counted.append((c["B"], c["H"] // 2, c["W"] // 2, c["C"], 4 * c["O"], c["residual"]))
        else:
            counted.append((c["B"], c["H"], c["W"], c["C"], c["O"], c["residual"]))
    assert sorted(seen) == sorted(counted)
