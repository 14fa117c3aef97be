"""The port's BatchNorm fold (debiasing_multi_modal_tpu_torch/weights/fold.py)
and its ``fuse_bn`` ResNet against the JAX package's, under realistic
statistics (mean ~ N(0, 0.2^2), var ~ U(0.5, 2), as tests/test_fold.py):

- the fold is bit-equal to the JAX fold carried across by
  ``state_dict_from_jax_variables`` (both compute in float64 and cast once);
- the tiny folded CLIP's ``encode_image`` is within 1e-4 of the output's
  scale of the JAX folded model's and of the port's unfused model's (f32 on
  the CPU; convolutions sum in another order than XLA's, and folding moves
  the BatchNorm's rounding into the weights);
- a ViT state dict raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu.models import create_clip as jax_create_clip
from debiasing_multi_modal_tpu.models import init_clip
from debiasing_multi_modal_tpu.models.config import CLIPConfig as JaxConfig
from debiasing_multi_modal_tpu.weights.fold import fold_resnet_bn as jax_fold
from debiasing_multi_modal_tpu_torch.models import CLIPConfig, create_clip
from debiasing_multi_modal_tpu_torch.weights.convert import (
    clip_from_state_dict,
    config_from_state_dict,
    state_dict_from_jax_variables,
)
from debiasing_multi_modal_tpu_torch.weights.fold import fold_resnet_bn

# the configuration of tests/test_fold.py
CFG = dict(
    name="fold-rn", embed_dim=64, image_resolution=64, vision_layers=(1, 1, 1, 1),
    vision_width=8, vision_patch_size=None, transformer_width=64,
    transformer_heads=1, transformer_layers=1,
)


def _realistic_stats(variables, rng):
    """Non-trivial, well-conditioned BatchNorm statistics."""

    def stat(a, key):
        if key == "mean":
            return np.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.2)
        return np.asarray(rng.uniform(0.5, 2.0, a.shape).astype(np.float32))

    out = dict(variables)
    out["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: stat(a, path[-1].key), variables["batch_stats"])
    return out


@pytest.fixture(scope="module")
def folded_pair():
    rng = np.random.default_rng(0)
    jm = jax_create_clip(JaxConfig(**CFG))
    variables = _realistic_stats(jax.device_get(init_clip(jm, jax.random.PRNGKey(0))), rng)
    return variables, jax_fold(variables)


def _close(ours, ref, rel=1e-4):
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def test_fold_bit_equal_to_jax_fold(folded_pair):
    variables, jfolded = folded_pair
    ours = fold_resnet_bn(state_dict_from_jax_variables(variables))
    ref = state_dict_from_jax_variables(jfolded)
    assert set(ours) == set(ref)
    assert not any(".bn" in k or "downsample.1" in k for k in ref if k.startswith("visual."))
    assert "visual.layer1.0.downsample.0.bias" in ref and "visual.conv1.bias" in ref
    for key, value in ref.items():
        assert ours[key].dtype == value.dtype and np.array_equal(ours[key], value), key


def test_folded_clip_matches_jax_and_unfused(folded_pair):
    variables, jfolded = folded_pair
    imgs = np.random.default_rng(1).standard_normal((3, 64, 64, 3)).astype(np.float32)
    fused_jax = jax_create_clip(JaxConfig(**CFG), fuse_bn=True)
    ref = np.asarray(fused_jax.apply(jfolded, jnp.asarray(imgs), method=fused_jax.encode_image))

    sd = state_dict_from_jax_variables(variables)
    folded = fold_resnet_bn(sd)
    assert config_from_state_dict(folded, name="fold-rn") == CLIPConfig(**CFG)
    model = clip_from_state_dict(folded, name="fold-rn", device="cpu", fuse_bn=True)
    unfused = create_clip(CLIPConfig(**CFG), device="cpu")
    unfused.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(imgs)).numpy()
        plain = unfused.encode_image(torch.from_numpy(imgs)).numpy()
    _close(got, ref)
    _close(got, plain)


def test_fold_rejects_vit():
    vit = JaxConfig(name="v", embed_dim=32, image_resolution=32, vision_layers=1,
                    vision_width=64, vision_patch_size=16, transformer_width=64,
                    transformer_heads=1, transformer_layers=1)
    variables = jax.device_get(init_clip(jax_create_clip(vit), jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="fold"):
        fold_resnet_bn(state_dict_from_jax_variables(variables))
