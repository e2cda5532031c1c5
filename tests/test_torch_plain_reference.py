"""MoGe-2's ``infer`` against the benchmark's plain reference
(``port_bench/reference``: plain fp32 torch, written from the published
models, no kernel of the port) on the CPU, at a tiny size: the tiny ViT
with the DINOv2 giant's fused SwiGLU feed-forward, and with the MLP. The
weights are the benchmark's seeded draw (``port_bench/weights.py``), so
the program and the reference read one state dict."""

import numpy as np
import pytest

from moge_tpu_torch.models import v2
from moge_tpu_torch.ops.resize import resize_2d
from port_bench import compare, program, weights
from port_bench.tests import tiny

TOKENS = 30


def _normal_lengths(monkeypatch):
    """The length of each pixel's resized normal vector before ``infer``'s
    epilogue divides by it, one (B, H, W) tensor a call."""
    lengths = []
    epilogue = v2.apply_epilogue

    def keep(raw, img_h, img_w, remap_output):
        vectors = resize_2d(raw["normal_raw"].float(), (img_h, img_w), mode="bilinear")
        lengths.append(vectors.norm(dim=-1))
        return epilogue(raw, img_h, img_w, remap_output)

    monkeypatch.setattr(v2, "apply_epilogue", keep)
    return lengths


@pytest.mark.parametrize("ffn", ["swiglu", "mlp"])
def test_tiny_moge2_infer_equals_the_plain_reference_in_fp32(ffn, monkeypatch):
    if ffn == "swiglu":  # the tiny arch (dinov2_vitt14) with the giant's feed-forward, in both tables
        tiny.swiglu(monkeypatch)
    _, _, config = tiny.cell("v2l-offline-b8-3600")
    sd = weights.draw("v2", config["model_config"], config["weights"], 2 ** 32 + 17, "cpu")
    assert ("encoder.backbone.blocks.0.mlp.w12.weight" in sd) == (ffn == "swiglu")
    model = program.build(config, sd, "cpu")
    images = weights.images(23, 2, 70, 84, "cpu")
    lengths = _normal_lengths(monkeypatch)
    out = model.infer(images, num_tokens=TOKENS, use_fp16=False)
    low_out = model.infer(images, num_tokens=TOKENS, use_fp16=True)
    for i in range(2):
        ref = compare.reference_outputs(config, sd, images[i], TOKENS)
        for key in ("points", "depth", "intrinsics"):
            got, want = out[key][i].numpy(), ref[key][0].numpy()
            finite = np.isfinite(want)  # masked-out pixels are inf in both
            assert (np.isfinite(got) == finite).all(), key
            # fp32 on both sides; the two sum the same products in another
            # order (fused projections, the solve's own loop), a few ulps that
            # the exp remap and the camera solve carry to ~1e-6 relative
            np.testing.assert_allclose(got[finite], want[finite], rtol=2e-5, atol=2e-6, err_msg=key)
        # each normal is the resized head vector over its length, which at
        # these random weights falls to ~0.04 of its median (~1.1) at some
        # pixels: there the direction carries the vector's few ulps grown by
        # 1 / length (2.2e-5 read). So the normals are held as the maps are,
        # at the vector's own scale: |n - n_ref| x length within 2e-6 + 2e-5
        # x length
        length = lengths[0][i].numpy()
        gap = np.linalg.norm(out["normal"][i].numpy() - ref["normal"][0].numpy(), axis=-1) * length
        assert (gap <= 2e-6 + 2e-5 * length).all(), (gap - 2e-5 * length).max()
        # the mask is a threshold of a logit far from it at these weights: exact
        assert (out["mask"][i].numpy() == ref["mask"][0].numpy()).all()
        # the tolerances hold the precision: the bf16 path is far outside them
        low = low_out["depth"][i].numpy()
        finite = np.isfinite(ref["depth"][0].numpy()) & np.isfinite(low)
        assert not np.allclose(low[finite], ref["depth"][0].numpy()[finite], rtol=2e-5, atol=2e-6)
