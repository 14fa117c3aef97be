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


def test_image_seq_len_matches_jax_config():
    from debiasing_multi_modal_tpu.models.config import get_config as jax_get_config

    for name in ("RN50", "RN50x4", "RN50x64", "ViT-B/32", "ViT-B/16", "ViT-L/14@336px"):
        assert get_config(name).image_seq_len == jax_get_config(name).image_seq_len, name
    assert CLIPConfig(**SMALL_RN).image_seq_len == JaxConfig(**SMALL_RN).image_seq_len == 5
    assert get_config("ViT-B/32").image_seq_len == 50


TINY_RN = dict(name="tiny-rn", embed_dim=64, image_resolution=64, vision_layers=(1, 1, 1, 1),
               vision_width=8, vision_patch_size=None, transformer_width=64,
               transformer_heads=1, transformer_layers=2)


def _reference_std_pairs(tm, jp):
    """(name, port tensor, JAX tensor, closed-form std) of every tensor the
    reference's initialize_parameters draws (the JAX test's list)."""
    width, layers = 64, 2
    attn_std, fc_std = width ** -0.5, (2 * width) ** -0.5
    proj_std = width ** -0.5 * (2 * layers) ** -0.5
    text = jp["text"]
    pairs = [("token_embedding", tm.token_embedding.weight,
              text["token_embedding"]["embedding"], 0.02),
             ("positional_embedding", tm.positional_embedding,
              text["positional_embedding"], 0.01),
             ("text_projection", tm.text_projection, text["text_projection"], attn_std)]
    for i, blk in enumerate(tm.transformer.resblocks):
        jblk = text["transformer"][f"resblocks_{i}"]
        w = blk.attn.in_proj_weight
        for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            pairs.append((f"{i}.{proj}", w[j * width:(j + 1) * width],
                          jblk["attn"][proj]["kernel"], attn_std))
        pairs += [(f"{i}.out_proj", blk.attn.out_proj.weight,
                   jblk["attn"]["out_proj"]["kernel"], proj_std),
                  (f"{i}.c_fc", blk.mlp.c_fc.weight, jblk["mlp"]["c_fc"]["kernel"], fc_std),
                  (f"{i}.c_proj", blk.mlp.c_proj.weight, jblk["mlp"]["c_proj"]["kernel"],
                   proj_std)]
    pool, jpool = tm.visual.attnpool, jp["visual"]["attnpool"]
    pool_std = pool.c_proj.in_features ** -0.5
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        pairs.append((f"attnpool.{proj}", getattr(pool, proj).weight, jpool[proj]["kernel"],
                      pool_std))
    return pairs


def test_reference_scratch_init_matches_jax_stds_and_zeros():
    """``scratch_init="reference"`` against the JAX package's
    ``init_clip(scratch_init="reference")``: the same tensors drawn, each
    sample std within 10 % of the closed form in both packages (the draws
    differ: torch and jax generators), every Bottleneck's bn3 weight zeroed
    in both, and an unknown mode refused by both."""
    jm = jax_create_clip(JaxConfig(**TINY_RN))
    jp = jax.device_get(init_clip(jm, jax.random.PRNGKey(0), scratch_init="reference"))["params"]
    tm = create_clip(CLIPConfig(**TINY_RN), device="cpu", scratch_init="reference")
    for name, ours, theirs, std in _reference_std_pairs(tm, jp):
        tol = 0.05 if name == "token_embedding" else 0.10
        assert abs(ours.float().std().item() - std) < std * tol, (name, "port")
        assert abs(float(np.std(np.asarray(theirs, np.float32))) - std) < std * tol, (name, "jax")
    from debiasing_multi_modal_tpu_torch.models.resnet import Bottleneck

    blocks = [m for m in tm.visual.modules() if isinstance(m, Bottleneck)]
    jax_bn3 = [sub["bn3"]["scale"] for name, sub in jp["visual"].items()
               if name.startswith("layer") and "bn3" in sub]
    assert len(blocks) == len(jax_bn3) == 4
    assert all(not b.bn3.weight.any() for b in blocks)
    assert all(not np.asarray(s).any() for s in jax_bn3)
    # everything else keeps the default draws: the stem conv, the other BatchNorms
    base = create_clip(CLIPConfig(**TINY_RN), device="cpu")
    assert torch.equal(base.visual.conv1.weight, tm.visual.conv1.weight)
    assert torch.equal(base.visual.layer1[0].bn1.weight, tm.visual.layer1[0].bn1.weight)
    assert torch.equal(base.visual.bn3.weight, tm.visual.bn3.weight)  # the stem's bn3
    with pytest.raises(ValueError, match="scratch_init"):
        create_clip(CLIPConfig(**TINY_RN), device="cpu", scratch_init="torch")
    with pytest.raises(ValueError, match="scratch_init"):
        init_clip(jm, jax.random.PRNGKey(0), scratch_init="torch")


def test_reference_scratch_init_keeps_the_vit_tower():
    """As in the JAX package, a ViT tower keeps its draws; the text side
    changes."""
    cfg = CLIPConfig(name="tiny-vit", embed_dim=64, image_resolution=64, vision_layers=2,
                     vision_width=64, vision_patch_size=16, transformer_width=64,
                     transformer_heads=1, transformer_layers=2)
    base = create_clip(cfg, device="cpu")
    ref = create_clip(cfg, device="cpu", scratch_init="reference")
    for (name, a), (_, b) in zip(base.visual.state_dict().items(),
                                 ref.visual.state_dict().items()):
        assert torch.equal(a, b), name
    assert not torch.equal(base.text_projection, ref.text_projection)
