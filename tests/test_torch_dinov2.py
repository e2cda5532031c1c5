"""The port's DINOv2 ViT (moge_tpu_torch.models.dinov2) against the JAX
package's ``DinoViT`` on the tiny ViT-T arch and on a tiny arch with the
giant's SwiGLU ffn, fp32 on the CPU, with the same weights carried over in
the torch DINOv2 state-dict layout."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moge_tpu.models.convert import export_dinov2_backbone
from moge_tpu.models.dinov2 import VIT_ARCHS as JAX_VIT_ARCHS, DinoViT
from moge_tpu.models.dinov2 import ViTConfig as JaxViTConfig
from moge_tpu_torch.models.dinov2 import VIT_ARCHS, DinoVisionTransformer, ViTConfig

torch.set_num_threads(1)

RTOL = 1e-4  # fp32 on both sides through 4 blocks: matmul and reduction order only
TAKE = (0, 1, 2, 3)


def test_arch_table_matches():
    """The port's archs are the JAX ones, the giant's SwiGLU ffn included;
    all use LayerScale and no register tokens, which the port builds in."""
    assert set(VIT_ARCHS) == set(JAX_VIT_ARCHS)
    for name, cfg in VIT_ARCHS.items():
        ref = JAX_VIT_ARCHS[name]
        assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.mlp_ratio, cfg.patch_size, cfg.pos_grid,
                cfg.interpolate_offset, cfg.ffn) == (ref.embed_dim, ref.depth, ref.num_heads, ref.mlp_ratio,
                                                     ref.patch_size, ref.pos_grid, ref.interpolate_offset, ref.ffn)
        assert ref.init_values is not None and ref.num_register_tokens == 0
    assert VIT_ARCHS["dinov2_vitg14"].mlp_hidden == 4096 and VIT_ARCHS["dinov2_vitl14"].mlp_hidden == 4096


# a tiny arch with the giant's fused SwiGLU ffn (head dim 32, hidden 256)
SWIGLU = {"jax": JaxViTConfig(embed_dim=96, depth=2, num_heads=3, ffn="swiglu"),
          "torch": ViTConfig(embed_dim=96, depth=2, num_heads=3, ffn="swiglu")}


@pytest.mark.parametrize("grid,ffn", [((4, 6), "mlp"), ((37, 37), "mlp"), ((4, 6), "swiglu")],
                         ids=["interpolated", "native", "swiglu"])
def test_vit_matches_jax(grid, ffn):
    """A 4x6 token grid runs the bicubic pos-embed interpolation; 37x37 skips
    it; the SwiGLU case runs the giant's ffn on a tiny arch, at the MLP
    cases' tolerance."""
    h0, w0 = grid
    cfg = SWIGLU["jax"] if ffn == "swiglu" else JAX_VIT_ARCHS["dinov2_vitt14"]
    take = (0, 1) if ffn == "swiglu" else TAKE
    rng = np.random.default_rng(h0 * w0)
    image = rng.standard_normal((2, 14 * h0, 14 * w0, 3)).astype(np.float32)
    vit = DinoViT(cfg, dtype=jnp.float32)
    params = jax.jit(vit.init, static_argnums=(2,))(jax.random.PRNGKey(0), jnp.asarray(image[:1]), take)["params"]
    want = vit.apply({"params": params}, jnp.asarray(image), take)

    sd = export_dinov2_backbone(jax.tree.map(np.asarray, params))
    model = DinoVisionTransformer(SWIGLU["torch"] if ffn == "swiglu" else VIT_ARCHS["dinov2_vitt14"])
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(image), take, torch.float32)
    assert len(got) == len(want)
    for (p_t, c_t), (p_j, c_j) in zip(got, want):
        for a, b in ((p_t, p_j), (c_t, c_j)):
            b = np.asarray(b)
            assert a.shape == b.shape
            scale = np.abs(b).max()
            np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=RTOL * scale)
