"""The plain reference against the program on the CPU, fp32, at a tiny
size: MoGe-2 and MoGe-1 ``infer``, and MoGe-2 on a tiny arch with the
giant's fused SwiGLU; and the reference's checkpoint layout against the
program's state dicts at the published sizes, the giant's included."""

import copy

import numpy as np
import pytest
import torch

from moge_tpu_torch.models import presets, v1, v2
from port_bench import compare, program, weights
from port_bench.reference import models
from port_bench.tests import tiny


def _published(name):
    """(version, model config) of a preset or of the giant's derived file."""
    if name == "moge-2-vitg14-normal":
        return "v2", tiny.giant_file()["model_config"]
    preset = presets.get_preset(name)
    return preset["version"], preset["config"]


@pytest.mark.parametrize("name", ["moge-2-vitl-normal", "moge-vitl", "moge-2-vitg14-normal"])
def test_layout_equals_the_programs_state_dict(name):
    version, cfg = _published(name)
    with torch.device("meta"):
        module = v2.MoGeV2(**cfg) if version == "v2" else v1.MoGeV1(**v1.normalize_config(cfg))
    specs = models.param_specs(version, cfg)
    assert [(k, tuple(v.shape)) for k, v in module.state_dict().items()] == [(k, tuple(s)) for k, s in specs]


# the tiny MoGe-2 and MoGe-1, and the tiny MoGe-2 with the giant's fused SwiGLU
CASES = [pytest.param("v2l-offline-b8-3600", False, id="v2l-offline-b8-3600"),
         pytest.param("v1l-folder-fp32-480x640", False, id="v1l-folder-fp32-480x640"),
         pytest.param("v2l-offline-b8-3600", True, id="v2l-offline-b8-3600-swiglu")]


@pytest.mark.parametrize("cell,swiglu", CASES)
def test_reference_equals_the_program_in_fp32(cell, swiglu, monkeypatch):
    if swiglu:
        tiny.swiglu(monkeypatch)
    _, workload, config = tiny.cell(cell)
    sd = weights.draw(config["version"], config["model_config"], config["weights"], 2 ** 31 + 3, "cpu")
    model = program.build(config, sd, "cpu")
    images = weights.images(11, 2, 60, 80, "cpu")
    out = model.infer(images, num_tokens=25, use_fp16=False)
    for i in range(2):
        ref = compare.reference_outputs(config, sd, images[i], 25)
        for key in ("depth", "points", "intrinsics"):
            got, want = out[key][i].numpy(), ref[key][0].numpy()
            finite = np.isfinite(want)
            assert (np.isfinite(got) == finite).all()
            np.testing.assert_allclose(got[finite], want[finite], rtol=2e-5, atol=2e-6)
        if "normal" in ref:
            np.testing.assert_allclose(out["normal"][i].numpy(), ref["normal"][0].numpy(), atol=2e-5)
        assert (out["mask"][i].numpy() == ref["mask"][0].numpy()).all()


def test_draw_is_the_same_for_the_same_seed_and_differs_otherwise():
    _, _, config = tiny.cell("v2l-offline-b8-3600")
    args = (config["version"], config["model_config"], config["weights"])
    a, b, c = (weights.draw(*args, s, "cpu") for s in (2 ** 33 + 1, 2 ** 33 + 1, 2 ** 33 + 2))
    assert all(torch.equal(a[k], b[k]) for k in a) and not all(torch.equal(a[k], c[k]) for k in a)


def test_perspective_routing_gives_the_solve_one_answer():
    """With the random part off (eps 0), the program's camera is the routed one."""
    _, _, config = tiny.cell("v1l-folder-fp32-480x640")
    config = copy.deepcopy(config)
    config["weights"]["eps"] = 0.0
    sd = weights.draw("v1", config["model_config"], config["weights"], 5, "cpu")
    out = program.build(config, sd, "cpu").infer(weights.images(1, 1, 60, 80, "cpu"), num_tokens=25, use_fp16=False)
    focal, aspect = config["weights"]["focal"], 80 / 60
    fx = focal / 2 * (1 + aspect ** 2) ** 0.5 / aspect
    assert out["intrinsics"][0, 0, 0].item() == pytest.approx(fx, rel=1e-4)


@pytest.mark.parametrize("cell,swiglu", CASES)
def test_outlier_channels_leave_every_float_answer_unchanged(cell, swiglu, monkeypatch):
    """The outlier channels move no bit of the bf16 or fp32 program's answer."""
    if swiglu:
        tiny.swiglu(monkeypatch)
    _, _, config = tiny.cell(cell)
    images = weights.images(4, 1, 60, 80, "cpu")
    outs = []
    for gain in (32.0, 1.0):
        cfg = copy.deepcopy(config)
        cfg["weights"]["outliers"]["gain"] = gain
        sd = weights.draw(cfg["version"], cfg["model_config"], cfg["weights"], 2 ** 31 + 9, "cpu")
        outs.append(program.build(cfg, sd, "cpu").infer(images, num_tokens=25, use_fp16=program.use_fp16(cfg)))
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])


def test_outlier_channels_scale_the_norms_and_the_next_linears():
    _, _, config = tiny.cell("v2l-offline-b8-3600")
    cfg = copy.deepcopy(config)
    args = (cfg["version"], cfg["model_config"])
    a = weights.draw(*args, cfg["weights"], 6, "cpu")
    cfg["weights"]["outliers"]["gain"] = 1.0
    b = weights.draw(*args, cfg["weights"], 6, "cpu")
    p = "encoder.backbone.blocks.1."
    picked = (a[p + "norm2.weight"] != b[p + "norm2.weight"]).nonzero()[:, 0]
    assert len(picked) == config["weights"]["outliers"]["channels"]
    assert torch.equal(a[p + "norm2.weight"][picked], b[p + "norm2.weight"][picked] * 32)
    assert torch.equal(a[p + "mlp.fc1.weight"][:, picked] * 32, b[p + "mlp.fc1.weight"][:, picked])
    cfg["weights"]["outliers"]["gain"] = 10.0
    with pytest.raises(ValueError, match="power of two"):
        weights.draw(*args, cfg["weights"], 6, "cpu")
