"""The port's sequence-parallel inference (moge_tpu_torch.parallel.sp) on
the CPU: ranks spawned over gloo (``parallel/distributed.py::spawn``, the
rank is ``torch_tiny_config.sp_rank``), token counts not divisible by the
ranks (31 tokens at sp = 2, 118 at sp = 4, as tests/test_sp.py). The SP
encode against the port's single-process encode and against the JAX
package's ``sequence_parallel_encode`` on the conftest's virtual CPU
devices; ``MoGeModel(sp_group=...).infer`` against JAX's ``sp_mesh`` infer
(a batch of two, so the gathers join more than one image); every rank's
result the same; a ``Leader`` call that raises on every rank, then a
server on rank 0 over the ``Leader``, the other rank following, each HTTP
answer against that image's batch-1 ``infer``; a training forward with a
group raises. fp32 throughout."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from moge_tpu.models.convert import convert_moge2, export_dinov2_backbone
from moge_tpu.models.dinov2 import DinoViT, ViTConfig as JaxViTConfig
from moge_tpu.models.v2 import MoGeModel as JaxMoGeModel
from moge_tpu.parallel.sp import sequence_parallel_encode as jax_sequence_parallel_encode
from moge_tpu_torch.models.dinov2 import DinoVisionTransformer, ViTConfig
from moge_tpu_torch.models.v2 import MoGeModel
from moge_tpu_torch.parallel.distributed import spawn
from torch_tiny_config import TINY_CONFIG, make_points_perspective, sp_rank

torch.set_num_threads(1)

ENCODE_TOL = 2e-5  # tests/test_sp.py's: fp32 on both sides, reduction order only
INFER_ATOL, INFER_RTOL = 1e-3, 1e-2  # tests/test_sp.py::test_sp_model_infer_matches's
SERVE_RTOL = 1e-3  # depth / normal / mask cross to the client as fp16 (11-bit mantissa)
VIT = dict(embed_dim=32, depth=4, num_heads=2, mlp_ratio=4.0)
# sp -> (batch, token grid, taken layers): 5 x 6 + 1 = 31 tokens, 9 x 13 + 1 = 118
ENCODE_CASES = {2: (1, (5, 6), (1,)), 4: (2, (9, 13), (1, 3))}
INFER_HW, NUM_TOKENS = (56, 70), 120  # a 10 x 12 grid: 121 tokens
SERVE_HW, SERVE_TOKENS, SERVE_REQUESTS = 56, 36, 4
SPS = sorted(ENCODE_CASES)


def _vit_case(sp):
    batch, (h0, w0), take = ENCODE_CASES[sp]
    rng = np.random.default_rng(sp)
    image = rng.standard_normal((batch, h0 * 14, w0 * 14, 3)).astype(np.float32)
    vit = DinoViT(JaxViTConfig(**VIT, patch_size=14, pos_grid=37, num_register_tokens=0), dtype=jnp.float32)
    params = vit.init(jax.random.PRNGKey(sp), jnp.asarray(image), take)["params"]
    return image, take, params


@pytest.fixture(scope="module")
def weights():
    """The tiny MoGe-2 with a well-conditioned point map
    (``make_points_perspective``), as the port's state dict and as JAX params."""
    model = MoGeModel(TINY_CONFIG, "cpu", torch.float32).init_random(seed=0)
    make_points_perspective(model.module)
    sd = {k: v.clone() for k, v in model.module.state_dict().items()}
    # copies: spawning the ranks moves the tensors' storage to shared memory
    _, params = convert_moge2({"model_config": TINY_CONFIG, "model": {k: np.array(v) for k, v in sd.items()}})
    return sd, params


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """sp -> (inputs, every rank's record) of one spawned run per sp."""
    sd, _ = weights
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (2, *INFER_HW, 3)).astype(np.float32)
    served = [rng.integers(0, 256, (SERVE_HW, SERVE_HW, 3), dtype=np.uint8) for _ in range(SERVE_REQUESTS)]
    out = {}
    for sp in SPS:
        image, take, params = _vit_case(sp)
        vit_sd = {k: torch.from_numpy(np.array(v)) for k, v in export_dinov2_backbone(params).items()}
        tmp = tmp_path_factory.mktemp(f"sp{sp}")
        job = {"vit": (VIT, vit_sd, image, take), "model": (TINY_CONFIG, sd, images, dict(num_tokens=NUM_TOKENS,
                                                                                           use_fp16=False)),
               "serve": (SERVE_HW, SERVE_TOKENS, served) if sp == 2 else None, "out": str(tmp)}
        spawn(sp_rank, sp, "cpu", tmp / "rendezvous", (job,))
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(sp)]
        out[sp] = ({"image": image, "take": take, "params": params, "vit_sd": vit_sd, "images": images,
                    "served": served}, ranks)
    return out


def _assert_encode(got, want, tol):
    assert len(got) == len(want)
    for (p_got, c_got), (p_want, c_want) in zip(got, want):
        assert p_got.shape == np.shape(p_want) and c_got.shape == np.shape(c_want)
        np.testing.assert_allclose(p_got, np.asarray(p_want), atol=tol, rtol=tol)
        np.testing.assert_allclose(c_got, np.asarray(c_want), atol=tol, rtol=tol)


@pytest.mark.parametrize("sp", SPS, ids=lambda sp: f"sp{sp}")
def test_sp_encode_matches_single_process(runs, sp):
    inputs, ranks = runs[sp]
    vit = DinoVisionTransformer(ViTConfig(**VIT))
    vit.load_state_dict(inputs["vit_sd"], strict=True)
    with torch.inference_mode():
        want = [(p.numpy(), c.numpy()) for p, c in vit(torch.from_numpy(inputs["image"]), inputs["take"],
                                                        torch.float32)]
    _assert_encode(ranks[0]["encode"], want, ENCODE_TOL)


@pytest.mark.parametrize("sp", SPS, ids=lambda sp: f"sp{sp}")
def test_sp_encode_matches_jax(runs, sp):
    inputs, ranks = runs[sp]
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    cfg = JaxViTConfig(**VIT, patch_size=14, pos_grid=37, num_register_tokens=0)
    encode = jax.jit(lambda params, image: jax_sequence_parallel_encode(cfg, params, image, inputs["take"], mesh))
    want = encode(inputs["params"], jnp.asarray(inputs["image"]))
    _assert_encode(ranks[0]["encode"], want, ENCODE_TOL)


@pytest.mark.parametrize("sp", SPS, ids=lambda sp: f"sp{sp}")
def test_sp_infer_matches_jax(runs, weights, sp):
    inputs, ranks = runs[sp]
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    jax_model = JaxMoGeModel(TINY_CONFIG, weights[1], dtype=jnp.float32, sp_mesh=mesh)
    want = jax_model.infer(jnp.asarray(inputs["images"]), num_tokens=NUM_TOKENS, use_fp16=False)
    got = ranks[0]["infer"]
    assert set(got) == set(want) == {"points", "depth", "intrinsics", "mask", "normal"}
    for key in want:
        np.testing.assert_allclose(got[key].astype(np.float32), np.asarray(want[key], np.float32),
                                   atol=INFER_ATOL, rtol=INFER_RTOL, err_msg=key)


@pytest.mark.parametrize("sp", SPS, ids=lambda sp: f"sp{sp}")
def test_every_rank_returns_the_whole_result(runs, sp):
    _, ranks = runs[sp]
    for r in range(1, sp):
        _assert_encode(ranks[r]["encode"], ranks[0]["encode"], 0.0)
        assert set(ranks[r]["infer"]) == set(ranks[0]["infer"])
        for key, want in ranks[0]["infer"].items():
            np.testing.assert_array_equal(ranks[r]["infer"][key], want, err_msg=key)


@pytest.mark.parametrize("sp", SPS, ids=lambda sp: f"sp{sp}")
def test_a_training_forward_with_a_group_raises(runs, sp):
    _, ranks = runs[sp]
    assert all(rank["training_raised"] == {"vit": True, "moge2": True} for rank in ranks)


def test_sp_serving_answers_match_batch1_infer(runs, weights):
    """A ``Leader`` call that raises on both ranks, then the server on rank
    0 over the ``Leader``, rank 1 still following: every answer against the
    image's batch-1 ``infer`` of one process."""
    inputs, ranks = runs[2]
    assert ranks[0]["failed"] is True
    assert ranks[0]["stats"]["requests"] == SERVE_REQUESTS and ranks[0]["stats"]["errors"] == 0
    assert ranks[1]["joined"] == ranks[0]["stats"]["batches"] + 1  # the failed call, then one per batch
    model = MoGeModel(TINY_CONFIG, "cpu", torch.float32)
    model.module.load_state_dict(weights[0], strict=True)
    for image, answer in zip(inputs["served"], ranks[0]["served"]):
        want = model.infer(torch.from_numpy(image.astype(np.float32) / 255.0), num_tokens=SERVE_TOKENS, use_fp16=False)
        assert set(answer) == set(want)
        for key, w in want.items():
            w = w.float().numpy()
            fin = np.isfinite(w)
            np.testing.assert_array_equal(np.isfinite(answer[key]), fin, err_msg=key)
            np.testing.assert_allclose(answer[key][fin], w[fin], rtol=SERVE_RTOL, atol=SERVE_RTOL, err_msg=key)
