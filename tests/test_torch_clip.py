"""Both CLIP towers of the port (debiasing_multi_modal_tpu_torch/models)
against the JAX package on one set of weights — JAX's ``init_clip`` carried
across by ``state_dict_from_jax_variables`` — f32 on the CPU, and the weight
conversion at the full RN50 shapes.

Tolerance: 1e-4 relative to the output's scale (convolutions and GEMMs sum
in another order than XLA's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu.models import create_clip as jax_create_clip
from debiasing_multi_modal_tpu.models import init_clip
from debiasing_multi_modal_tpu.models.config import CLIPConfig as JaxConfig
from debiasing_multi_modal_tpu_torch.models import CLIPConfig, create_clip, get_config
from debiasing_multi_modal_tpu_torch.models.clip import l2_normalize
from debiasing_multi_modal_tpu_torch.weights.convert import (
    clip_from_state_dict,
    config_from_state_dict,
    state_dict_from_jax_variables,
)

SMALL_RN = dict(
    name="small-rn", embed_dim=64, image_resolution=64, vision_layers=(1, 1, 1, 1),
    vision_width=16, vision_patch_size=None, transformer_width=128,
    transformer_heads=2, transformer_layers=2,
)


def _close(ours, ref, rel=1e-4):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * scale)


@pytest.fixture(scope="module")
def pair():
    jm = jax_create_clip(JaxConfig(**SMALL_RN))
    variables = jax.device_get(init_clip(jm, jax.random.PRNGKey(0)))
    sd = state_dict_from_jax_variables(variables)
    tm = create_clip(CLIPConfig(**SMALL_RN), device="cpu")
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return jm, variables, tm


def _tokens(n, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, 77), np.int32)
    toks[:, 0] = 49406
    for i in range(n):
        end = int(rng.integers(2, 76))
        toks[i, 1:end] = rng.integers(1, 49406, end - 1)
        toks[i, end] = 49407
    return toks


def test_encode_text_matches_jax(pair):
    jm, variables, tm = pair
    toks = _tokens(5)
    ref = np.asarray(jm.apply(variables, jnp.asarray(toks), method=jm.encode_text))
    with torch.no_grad():
        ours = tm.encode_text(torch.from_numpy(toks)).numpy()
    _close(ours, ref)


def test_encode_image_matches_jax(pair):
    jm, variables, tm = pair
    img = np.random.default_rng(1).standard_normal((3, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(img), method=jm.encode_image))
    with torch.no_grad():
        ours = tm.encode_image(torch.from_numpy(img)).numpy()
    _close(ours, ref)


def test_forward_logits_match_jax(pair):
    jm, variables, tm = pair
    img = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
    toks = _tokens(3, seed=3)
    ref, ref_t = jm.apply(variables, jnp.asarray(img), jnp.asarray(toks))
    with torch.no_grad():
        ours, ours_t = tm(torch.from_numpy(img), torch.from_numpy(toks))
    _close(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ours_t.numpy(), ours.numpy().T)


BF16_ULP = 2.0 ** -8  # one bf16 ulp at magnitude 1 (8 significand bits)


@pytest.mark.parametrize("tower", ["text", "image"])
def test_bf16_towers_match_jax(pair, tower):
    """The card's numerics policy (f32 params cast to bf16 at use, f32 norm
    statistics, logits stored in bf16) against the JAX package's at
    dtype=bf16 on one set of weights.  Both sum in f32 and round at the same
    places, so outputs differ only where the summation order flips a
    rounding: within 2 bf16 ulps of the output's scale, and at least a
    tenth of the elements bit-equal (a tower computing in f32 shares none)."""
    _, variables, _ = pair
    jm = jax_create_clip(JaxConfig(**SMALL_RN), dtype=jnp.bfloat16)
    tm = create_clip(CLIPConfig(**SMALL_RN), dtype=torch.bfloat16, device="cpu")
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        state_dict_from_jax_variables(variables).items()}, strict=True)
    if tower == "text":
        x = _tokens(5)
        ref = jm.apply(variables, jnp.asarray(x), method=jm.encode_text)
        with torch.no_grad():
            ours = tm.encode_text(torch.from_numpy(x))
    else:
        x = np.random.default_rng(1).standard_normal((3, 64, 64, 3)).astype(np.float32)
        ref = jm.apply(variables, jnp.asarray(x, jnp.bfloat16), method=jm.encode_image)
        with torch.no_grad():
            ours = tm.encode_image(torch.from_numpy(x).bfloat16())
    assert ref.dtype == jnp.bfloat16 and ours.dtype == torch.bfloat16
    ref = np.asarray(ref).astype(np.float32)
    ours = ours.float().numpy()
    _close(ours, ref, rel=2 * BF16_ULP)
    assert (ours == ref).mean() >= 0.1


def test_l2_normalize_unit_norm_and_dtype():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 8)).astype(np.float32))
    n = l2_normalize(x.bfloat16())
    assert n.dtype == torch.bfloat16
    torch.testing.assert_close(l2_normalize(x).norm(dim=-1), torch.ones(3))


def test_full_rn50_state_dict_round_trip():
    """The full RN50 tree's shapes (jax.eval_shape, no init) filled from a
    seed -> state dict -> strict load -> config sniffing, key for key."""
    jm = jax_create_clip("RN50")
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
        jnp.zeros((1, 77), jnp.int32),
    )
    rng = np.random.default_rng(0)
    variables = jax.tree.map(
        lambda s: rng.standard_normal(s.shape, dtype=np.float32), shapes
    )
    sd = state_dict_from_jax_variables(variables)
    cfg = config_from_state_dict(sd, name="RN50")
    ref = get_config("RN50")
    assert cfg == ref
    model = clip_from_state_dict(sd, name="RN50", device="cpu")
    assert model.config == ref
    loaded = model.state_dict()
    assert set(loaded) == set(sd)
    for key, value in sd.items():
        assert torch.equal(loaded[key], torch.as_tensor(value)), key


def test_create_clip_without_cuda_needs_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_clip(CLIPConfig(**SMALL_RN))


def test_vit_and_options_not_yet_ported():
    """ViT-B/32 builds at its full shapes (and ignores ``fuse_bn``, as the
    JAX package does); ``fuse_bn=True`` builds a ResNet tower whose convs
    carry zero biases and which has no BatchNorm modules."""
    from debiasing_multi_modal_tpu_torch.models import VisionTransformer
    from debiasing_multi_modal_tpu_torch.models.layers import InferenceBatchNorm

    model = create_clip("ViT-B/32", device="cpu", fuse_bn=True)
    assert isinstance(model.visual, VisionTransformer)
    assert model.visual.conv1.weight.shape == (768, 3, 32, 32)
    assert model.visual.positional_embedding.shape == (50, 768)
    assert len(model.visual.transformer.resblocks) == 12
    folded = create_clip(CLIPConfig(**SMALL_RN), device="cpu", fuse_bn=True)
    convs = [m for m in folded.visual.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 3 + 4 * 3 + 4  # stem, three per block, four downsamples
    assert all(c.bias is not None and not c.bias.any() for c in convs)
    assert not any(isinstance(m, InferenceBatchNorm) for m in folded.modules())
    keys = set(folded.state_dict())
    assert "visual.layer1.0.downsample.0.bias" in keys and "visual.conv1.bias" in keys
    assert not any(".bn" in k or "downsample.1" in k for k in keys)
