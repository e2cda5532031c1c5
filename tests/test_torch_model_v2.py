"""The PyTorch port's MoGe-2 (moge_tpu_torch.models.v2) against the JAX
package on a tiny config, with the same weights carried over by the weight
bridge. Everything runs on the CPU in fp32, where the port's kernel wrappers
take their plain PyTorch versions."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moge_tpu.models.v2 import MoGeModel as JaxMoGeModel, apply_epilogue as jax_apply_epilogue
from moge_tpu_torch.models.v2 import MoGeModel, base_token_grid
from moge_tpu_torch.ops import _build, attention, conv, norm
from torch_tiny_config import TINY_CONFIG, state_dict_from_jax_params

torch.set_num_threads(1)

NUM_TOKENS = 16
RAW_RTOL = 1e-4   # raw decoder maps: fp32 on both sides, only reduction order differs
OUT_RTOL = 1e-3   # outputs after the 30-step LM solve
MASK_BAND = 1e-4  # mask pixels whose probability is this close to 0.5 may flip


@pytest.fixture(scope="module")
def models():
    jm = JaxMoGeModel(TINY_CONFIG, None, dtype=jnp.float32).init_random(seed=0, image_hw=(56, 56))
    sd = state_dict_from_jax_params(TINY_CONFIG, jax.tree.map(np.asarray, jm.params))
    tm = MoGeModel(TINY_CONFIG, "cpu", torch.float32)
    tm.module.load_state_dict(sd, strict=True)
    return jm, tm, sd


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


@pytest.mark.parametrize("hw", [(56, 112), (70, 70), (112, 56)], ids=["2to1", "1to1", "1to2"])
def test_infer_matches_jax(models, hw):
    jm, tm, _ = models
    rng = np.random.default_rng(sum(hw))
    image = rng.uniform(0, 1, (*hw, 3)).astype(np.float32)
    h, w = hw
    aspect = w / h
    bh, bw = base_token_grid(NUM_TOKENS, aspect)

    # decode: raw maps at decoder resolution (and the JAX decode program the
    # infer calls below reuse)
    image_14 = jm._resize_in_fn(bh, bw)(jnp.asarray(image[None]))
    raw_j = jm._decode_fn(bh, bw, jnp.float32)(jm.params, image_14, jnp.float32(aspect))
    with torch.inference_mode():
        raw_t = tm.module.decode(torch.from_numpy(np.array(image_14)), bh, bw, aspect, torch.float32)
    assert set(raw_t) == set(raw_j)
    for key in raw_j:
        assert raw_t[key].shape == raw_j[key].shape, key
        assert _rel(raw_j[key], raw_t[key]) <= RAW_RTOL, key

    mask_prob = np.asarray(jax_apply_epilogue(raw_j, h, w, "exp")["mask"][0])
    settled = np.abs(mask_prob - 0.5) > MASK_BAND
    for fov_x in (None, 60.0):
        out_j = jm.infer(image, num_tokens=NUM_TOKENS, fov_x=fov_x, use_fp16=False)
        out_t = tm.infer(image, num_tokens=NUM_TOKENS, fov_x=fov_x, use_fp16=False)
        assert set(out_t) == set(out_j) == {"points", "depth", "intrinsics", "mask", "normal"}
        mj, mt = np.asarray(out_j["mask"]), out_t["mask"].numpy()
        np.testing.assert_array_equal(mj[settled], mt[settled])
        agree = mj == mt
        for key in ("points", "depth", "intrinsics", "normal"):
            a, b = np.asarray(out_j[key]), out_t[key].numpy()
            assert a.shape == b.shape, key
            if key == "intrinsics":
                assert _rel(a, b) <= OUT_RTOL
                continue
            sel = agree if a.ndim == 2 else agree[..., None].repeat(3, -1)
            np.testing.assert_array_equal(np.isfinite(a[sel]), np.isfinite(b[sel]))
            fin = sel & np.isfinite(a)
            assert _rel(a[fin], b[fin]) <= OUT_RTOL, (key, fov_x)


def test_fov_x_sets_the_focal(models):
    _, tm, _ = models
    image = np.random.default_rng(5).uniform(0, 1, (56, 112, 3)).astype(np.float32)
    out = tm.infer(image, num_tokens=NUM_TOKENS, fov_x=60.0, use_fp16=False)
    fx = out["intrinsics"][0, 0].item()
    np.testing.assert_allclose(fx, 0.5 / np.tan(np.deg2rad(30.0)), rtol=1e-6)


def test_batched_nchw_infer_matches_single_images(models):
    """A batch (given NCHW) gives each image's own result: the solve and the
    masking are per image."""
    _, tm, _ = models
    images = np.random.default_rng(7).uniform(0, 1, (2, 56, 112, 3)).astype(np.float32)
    batched = tm.infer(torch.from_numpy(images).permute(0, 3, 1, 2), num_tokens=NUM_TOKENS, use_fp16=False)
    for i in range(2):
        single = tm.infer(images[i], num_tokens=NUM_TOKENS, use_fp16=False)
        for key in single:
            np.testing.assert_allclose(batched[key][i].numpy(), single[key].numpy(), rtol=1e-5, atol=1e-6)


def test_bf16_infer_on_cpu_stays_close_to_fp32(models):
    """use_fp16=True computes the network in bf16 (the plain versions on the
    CPU); raw maps stay within the bf16 rounding of the fp32 ones."""
    _, tm, _ = models
    image = torch.from_numpy(np.random.default_rng(8).uniform(0, 1, (1, 56, 56, 3)).astype(np.float32))
    with torch.inference_mode():
        raw16 = tm.module.decode(image, 4, 4, 1.0, torch.bfloat16)
        raw32 = tm.module.decode(image, 4, 4, 1.0, torch.float32)
    for key in raw32:
        assert raw16[key].dtype == torch.bfloat16
        rel = ((raw16[key].float() - raw32[key]).norm() / raw32[key].norm()).item()
        assert rel <= 3e-2, key  # the tolerance chip_smoke.py holds the card's bf16 decode to


def test_from_pretrained_roundtrip(models, tmp_path):
    _, tm, sd = models
    path = tmp_path / "model.pt"
    torch.save({"model_config": TINY_CONFIG, "model": sd}, path)
    loaded = MoGeModel.from_pretrained(path, device="cpu", dtype=torch.float32)
    image = np.random.default_rng(3).uniform(0, 1, (70, 70, 3)).astype(np.float32)
    a = tm.infer(image, num_tokens=NUM_TOKENS, use_fp16=False)
    b = loaded.infer(image, num_tokens=NUM_TOKENS, use_fp16=False)
    for key in a:
        np.testing.assert_array_equal(a[key].numpy(), b[key].numpy())


def test_presets_match_the_jax_package():
    from moge_tpu.models.presets import MODEL_PRESETS as JAX_PRESETS
    from moge_tpu_torch.models.presets import MODEL_PRESETS

    assert MODEL_PRESETS == JAX_PRESETS


def test_port_imports_no_jax():
    code = ("import sys, moge_tpu_torch, moge_tpu_torch.models.v2, moge_tpu_torch.models.v1; "
            "bad = [m for m in ('jax', 'flax') if m in sys.modules]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the kernel wrappers run their plain versions and count no launch."""
    _build.reset_launches()
    x = torch.randn(5, 64)
    norm.layer_norm_fp32(x, torch.ones(64), torch.zeros(64))
    q = torch.randn(1, 9, 2, 64)
    attention.flash_attention(q, q, q)
    conv.conv3x3_replicate(torch.randn(1, 5, 4, 8), torch.randn(3, 3, 8, 4), torch.zeros(4))
    conv.conv3x3_up2_bilinear(torch.randn(1, 5, 4, 8), torch.randn(3, 3, 8, 4), torch.zeros(4))
    assert not any(_build.LAUNCHES.values())


def test_wrappers_refuse_other_devices():
    """Off the CPU the wrappers launch their kernel or raise; a meta tensor is neither."""
    x = torch.empty(5, 64, device="meta")
    with pytest.raises(ValueError):
        norm.layer_norm_fp32(x, torch.ones(64, device="meta"), torch.zeros(64, device="meta"))
    with pytest.raises(ValueError):
        attention.flash_attention(torch.empty(1, 9, 2, 64, device="meta"),
                                  torch.empty(1, 9, 2, 64, device="meta"),
                                  torch.empty(1, 9, 2, 64, device="meta"))
    with pytest.raises(ValueError):
        conv.conv3x3_replicate(torch.empty(1, 5, 4, 8, device="meta"),
                               torch.empty(3, 3, 8, 4, device="meta"), None)
