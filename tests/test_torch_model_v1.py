"""The PyTorch port's MoGe-1 (moge_tpu_torch.models.v1) against the JAX
package on tiny configs (``dinov2_vitt14``), with the same weights carried
over by ``export_moge1``; checkpoint loading and the legacy config keys.
Everything runs on the CPU in fp32, where the kernel wrappers take their
plain PyTorch versions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moge_tpu.models.v1 import MoGeModel as JaxMoGeModel
from moge_tpu_torch.models import import_model_class_by_version
from moge_tpu_torch.models.io import load_checkpoint
from moge_tpu_torch.models.v1 import MoGeModel, normalize_config
from torch_tiny_config import v1_state_dict_from_jax_params

torch.set_num_threads(1)

RAW_RTOL = 1e-4   # raw points / mask: fp32 on both sides, only reduction order differs
OUT_RTOL = 1e-3   # outputs after the 30-step LM solve
MASK_BAND = 1e-4  # raw mask values this close to the threshold may flip
NUM_TOKENS = 64


def _config(norm):
    return {"encoder": "dinov2_vitt14", "intermediate_layers": 4, "dim_proj": 32, "dim_upsample": [32, 16, 16],
            "dim_times_res_block_hidden": 2, "num_res_blocks": 1, "remap_output": "exp", "res_block_norm": norm,
            "last_res_blocks": 1, "last_conv_channels": 32, "last_conv_size": 1}


def _perspective_points_head(sd):
    """Random weights give degenerate point maps (a negative focal), where
    the LM solve is ill-conditioned and the two packages' solvers, whose
    derivatives are computed differently, part at ~1e-3. So the points
    output block passes the view-plane UV through (its last two input
    channels, +-10 into channels 0-3 of its first conv, read back as
    x = ch0 - ch2, y = ch1 - ch3 by the 1x1 output conv) over the random
    weights: a near-perspective point map that the solve pins down."""
    sd = {k: v.clone() for k, v in sd.items()}
    w_in = sd["head.output_block.0.0.weight"]  # (32, C + 2, 3, 3)
    w_in[:4] = 0
    for ch, (src, sign) in enumerate(((-2, 10), (-1, 10), (-2, -10), (-1, -10))):
        w_in[ch, src, 1, 1] = sign
    w_out = sd["head.output_block.0.3.weight"]  # (3, 32, 1, 1)
    w_out *= 0.1
    for ch, (a, b) in enumerate(((0, 2), (1, 3))):
        w_out[ch, a, 0, 0] += 1
        w_out[ch, b, 0, 0] -= 1
    return sd


@pytest.fixture(scope="module", params=["group_norm", "layer_norm"])
def models(request):
    from moge_tpu.models.convert import convert_moge1

    cfg = _config(request.param)
    jm = JaxMoGeModel(cfg, None, dtype=jnp.float32).init_random(seed=0, image_hw=(112, 112))
    sd = _perspective_points_head(v1_state_dict_from_jax_params(cfg, jax.tree.map(np.asarray, jm.params)))
    _, params = convert_moge1({"model_config": cfg, "model": {k: v.numpy() for k, v in sd.items()}})
    jm = JaxMoGeModel(cfg, params, dtype=jnp.float32)
    tm = MoGeModel(cfg, "cpu", torch.float32)
    tm.module.load_state_dict(sd, strict=True)
    return cfg, jm, tm, sd


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


@pytest.mark.parametrize("hw", [(112, 140), (98, 98)], ids=["4to5", "1to1"])
def test_infer_matches_jax(models, hw):
    _, jm, tm, _ = models
    image = np.random.default_rng(sum(hw)).uniform(0, 1, (*hw, 3)).astype(np.float32)
    raw_j = jm.forward(jnp.asarray(image[None]), NUM_TOKENS)
    with torch.inference_mode():
        raw_t = tm.module(torch.from_numpy(image[None]), NUM_TOKENS, torch.float32)
    assert set(raw_t) == set(raw_j) == {"points", "mask"}
    for key in raw_j:
        assert raw_t[key].shape == raw_j[key].shape, key
        assert _rel(raw_j[key], raw_t[key]) <= RAW_RTOL, key

    settled = np.abs(np.asarray(raw_j["mask"][0]) - 0.5) > MASK_BAND
    for kwargs in ({}, {"fov_x": 60.0}, {"force_projection": False}):
        out_j = jm.infer(image, num_tokens=NUM_TOKENS, **kwargs)
        out_t = tm.infer(image, num_tokens=NUM_TOKENS, use_fp16=False, **kwargs)
        assert set(out_t) == set(out_j) == {"points", "depth", "intrinsics", "mask"}
        mj, mt = np.asarray(out_j["mask"]), out_t["mask"].numpy()
        np.testing.assert_array_equal(mj[settled], mt[settled])
        agree = mj == mt
        assert _rel(out_j["intrinsics"], out_t["intrinsics"]) <= OUT_RTOL
        for key in ("points", "depth"):
            a, b = np.asarray(out_j[key]), out_t[key].numpy()
            assert a.shape == b.shape, key
            sel = agree if a.ndim == 2 else agree[..., None].repeat(3, -1)
            np.testing.assert_array_equal(np.isfinite(a[sel]), np.isfinite(b[sel]))
            fin = sel & np.isfinite(a)
            assert _rel(a[fin], b[fin]) <= OUT_RTOL, (key, kwargs)


def test_fov_x_sets_the_focal(models):
    _, _, tm, _ = models
    image = np.random.default_rng(5).uniform(0, 1, (112, 140, 3)).astype(np.float32)
    out = tm.infer(image, num_tokens=NUM_TOKENS, fov_x=60.0, use_fp16=False)
    np.testing.assert_allclose(out["intrinsics"][0, 0].item(), 0.5 / np.tan(np.deg2rad(30.0)), rtol=1e-6)


def test_legacy_config_keys_match_jax():
    for legacy in ({"trained_area_range": [500 * 196, 1000 * 196], "remap_output": True},
                   {"remap_output": False, "unknown_key": 1, "mask_threshold": 0.3}):
        cfg = {**_config("layer_norm"), **legacy}
        cfg.pop("remap_output") if "remap_output" not in legacy else None
        assert normalize_config(cfg) == JaxMoGeModel(cfg, None).config
    assert normalize_config({"trained_area_range": [500 * 196, 1000 * 196]})["num_tokens_range"] == [500, 1000]


def test_from_pretrained_roundtrip(models, tmp_path):
    cfg, _, tm, sd = models
    path = tmp_path / "model.pt"
    torch.save({"model_config": cfg, "model": sd}, path)
    config, state_dict = load_checkpoint(path, version="v1")
    assert config == cfg and set(state_dict) == set(sd)
    loaded = import_model_class_by_version("v1").from_pretrained(path, device="cpu", dtype=torch.float32)
    image = np.random.default_rng(3).uniform(0, 1, (98, 98, 3)).astype(np.float32)
    a = tm.infer(image, num_tokens=NUM_TOKENS, use_fp16=False)
    b = loaded.infer(image, num_tokens=NUM_TOKENS, use_fp16=False)
    for key in a:
        np.testing.assert_array_equal(a[key].numpy(), b[key].numpy())


def test_load_checkpoint_refuses_what_it_does_not_read(tmp_path):
    with pytest.raises(ValueError, match="Orbax"):
        load_checkpoint(tmp_path, version="v2")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "missing.pt", version="v1")
    with pytest.raises(ValueError):
        load_checkpoint(tmp_path / "missing.pt", version="v3")
    with pytest.raises(ValueError):
        import_model_class_by_version("v3")


def test_bf16_forward_on_cpu_stays_close_to_fp32(models):
    _, _, tm, _ = models
    image = torch.from_numpy(np.random.default_rng(8).uniform(0, 1, (1, 112, 112, 3)).astype(np.float32))
    with torch.inference_mode():
        raw16 = tm.module(image, NUM_TOKENS, torch.bfloat16)
        raw32 = tm.module(image, NUM_TOKENS, torch.float32)
    for key in raw32:
        rel = ((raw16[key] - raw32[key]).norm() / raw32[key].norm()).item()
        assert rel <= 3e-2, key  # the tolerance chip_smoke.py holds the card's bf16 decode to


@pytest.mark.parametrize("hw", [(112, 112), (84, 140)])
def test_infer_recovers_the_injected_focal(hw):
    """A tiny MoGe-1 whose point map is a known perspective
    (``make_points_perspective_v1``, focal 1.5): ``infer`` finds that focal,
    a shift of 0 and the surface's depth, with the whole image in the mask;
    the solve's degenerate fallback (focal 1) would miss fx by a third."""
    from torch_tiny_config import make_points_perspective_v1, perspective_v1_answer

    model = MoGeModel(_config("layer_norm"), "cpu", torch.float32).init_random(seed=0)
    make_points_perspective_v1(model.module)
    image = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (*hw, 3)).astype(np.float32))
    out = model.infer(image, num_tokens=NUM_TOKENS)
    fx, fy, depth = perspective_v1_answer(*hw)
    assert bool(out["mask"].all())
    intr = out["intrinsics"]
    assert abs(intr[0, 0].item() - fx) <= 1e-3 * fx and abs(intr[1, 1].item() - fy) <= 1e-3 * fy
    # the bilinear resize to the image clamps at its border: compare inside a 2-pixel margin
    inner = (slice(2, -2), slice(2, -2))
    assert ((out["depth"][inner] - depth[inner]).norm() / depth[inner].norm()).item() <= 1e-3
