"""The port's ViT CLIP (debiasing_multi_modal_tpu_torch/models/vit.py, with
``fuse_qkv`` and both int8 ``quant`` modes) against the JAX package's on one
set of weights — JAX's ``init_clip`` carried across by
``state_dict_from_jax_variables`` — f32 on the CPU, and the ViT weight
conversion.

The small ViT has the shape of tests/test_quant.py::_tiny_vit_config at
width 128 (two layers in each tower, two heads of 64, 64x64 images in 16x16
patches, a 16-token context).

Tolerances:
- unquantized towers: 1e-4 relative to the output's scale (GEMMs and
  LayerNorms sum in another order than XLA's);
- quantized towers: every image within 2/127 of the output's scale and at
  least three of four within 1e-4.  The int8 roundings are bit-equal to the
  JAX package's for equal inputs (tests/test_torch_quant.py), but the f32
  activations they quantize differ in the last bits, so now and then one
  ``x / scale`` lands on the other side of a .5 and one int8 element moves
  by one step, 1/127 of its row's maximum; the image it belongs to then
  differs by about one step, every other image not at all.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu.models import create_clip as jax_create_clip
from debiasing_multi_modal_tpu.models import init_clip
from debiasing_multi_modal_tpu.models.config import get_config as jax_get_config
from debiasing_multi_modal_tpu.weights.convert import (
    config_from_state_dict as jax_config_from_state_dict,
)
from debiasing_multi_modal_tpu_torch.models import CLIP, CLIPConfig, create_clip, get_config
from debiasing_multi_modal_tpu_torch.models.layers import QUANT_MODES, quant_impl
from debiasing_multi_modal_tpu_torch.ops.quant import Int8Dense
from debiasing_multi_modal_tpu_torch.weights.convert import (
    clip_from_state_dict,
    config_from_state_dict,
    state_dict_from_jax_variables,
)

SMALL_VIT = dict(
    name="small-vit", embed_dim=32, image_resolution=64, vision_layers=2,
    vision_width=128, vision_patch_size=16, transformer_width=128,
    transformer_heads=2, transformer_layers=2, vocab_size=128,
    context_length=16,
)


def _jax_cfg():
    return dataclasses.replace(jax_get_config("ViT-B/32"), **SMALL_VIT)


@pytest.fixture(scope="module")
def weights():
    variables = jax.device_get(init_clip(jax_create_clip(_jax_cfg()), jax.random.PRNGKey(0)))
    return variables, state_dict_from_jax_variables(variables)


def _port(sd, **kw):
    model = create_clip(CLIPConfig(**SMALL_VIT), device="cpu", **kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


def _images(seed, n=4):
    return np.random.default_rng(seed).standard_normal((n, 64, 64, 3)).astype(np.float32)


def _tokens(n, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, 16), np.int32)
    for i in range(n):
        end = int(rng.integers(2, 15))
        toks[i, :end] = rng.integers(1, 126, end)
        toks[i, end] = 127  # the highest id marks the end, as EOT does
    return toks


def _jax_encode(variables, images=None, tokens=None, **kw):
    jm = jax_create_clip(_jax_cfg(), **kw)
    if images is not None:
        return np.asarray(jm.apply(variables, jnp.asarray(images), method=jm.encode_image))
    return np.asarray(jm.apply(variables, jnp.asarray(tokens), method=jm.encode_text))


def _close(ours, ref, rel=1e-4):
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


@pytest.mark.parametrize("fuse_qkv", [False, True])
def test_towers_match_jax(weights, fuse_qkv):
    variables, sd = weights
    model = _port(sd, fuse_qkv=fuse_qkv)
    img, toks = _images(1), _tokens(5)
    with torch.no_grad():
        image = model.encode_image(torch.from_numpy(img)).numpy()
        text = model.encode_text(torch.from_numpy(toks)).numpy()
    assert image.shape == (4, 32) and text.shape == (5, 32)
    _close(image, _jax_encode(variables, images=img, fuse_qkv=fuse_qkv))
    _close(text, _jax_encode(variables, tokens=toks, fuse_qkv=fuse_qkv))


def test_fuse_qkv_towers_equal_unfused(weights):
    """One [D, 3D] GEMM computes each output column with the same
    contraction as the three [D, D] GEMMs, and the packed slab feeds the
    same attention: 1e-6 of scale (the BLAS may block the wider GEMM
    differently)."""
    _, sd = weights
    fused, plain = _port(sd, fuse_qkv=True), _port(sd)
    img, toks = torch.from_numpy(_images(2)), torch.from_numpy(_tokens(3, seed=1))
    with torch.no_grad():
        _close(fused.encode_image(img).numpy(), plain.encode_image(img).numpy(), rel=1e-6)
        _close(fused.encode_text(toks).numpy(), plain.encode_text(toks).numpy(), rel=1e-6)


@pytest.mark.parametrize("quant", ["int8", "int8_pallas"])
def test_quantized_image_tower_matches_jax(weights, quant):
    variables, sd = weights
    model = _port(sd, quant=quant)
    assert sum(isinstance(m, Int8Dense) for m in model.visual.modules()) == 2 * 3
    assert not any(isinstance(m, Int8Dense) for m in model.transformer.modules())
    full = _port(sd)
    rows_within_1e4 = 0
    for seed in range(4):
        img = _images(seed)
        ref = _jax_encode(variables, images=img, quant=quant)
        with torch.no_grad():
            ours = model.encode_image(torch.from_numpy(img)).numpy()
            unquant = full.encode_image(torch.from_numpy(img)).numpy()
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(ours, ref, rtol=0, atol=2 / 127 * scale)
        rows_within_1e4 += int((np.abs(ours - ref).max(axis=-1) <= 1e-4 * scale).sum())
        # JAX's own bound against the unquantized tower (tests/test_quant.py)
        cos = (ours * unquant).sum(-1) / (np.linalg.norm(ours, axis=-1)
                                          * np.linalg.norm(unquant, axis=-1))
        assert cos.min() > 0.99, cos
    assert rows_within_1e4 >= 12  # of 16 images


def test_quant_and_fuse_qkv_options():
    assert QUANT_MODES == ("none", "int8", "int8_pallas")
    assert quant_impl("int8_pallas") == "pallas" and quant_impl("int8") == "xla"
    rn = CLIPConfig(name="tiny-rn", embed_dim=32, image_resolution=32,
                    vision_layers=(1, 1, 1, 1), vision_width=8,
                    vision_patch_size=None, transformer_width=128,
                    transformer_heads=2, transformer_layers=1)
    with pytest.raises(ValueError, match="ViT-only"):
        create_clip(rn, device="cpu", quant="int8")
    with pytest.raises(ValueError, match="unknown quant"):
        create_clip(CLIPConfig(**SMALL_VIT), device="cpu", quant="int4")
    # fuse_qkv with quant takes the unfused quantized path, as in JAX
    both = create_clip(CLIPConfig(**SMALL_VIT), device="cpu", quant="int8", fuse_qkv=True)
    only = create_clip(CLIPConfig(**SMALL_VIT), device="cpu", quant="int8")
    img = torch.from_numpy(_images(5, n=2))
    with torch.no_grad():
        torch.testing.assert_close(both.encode_image(img), only.encode_image(img),
                                   rtol=0, atol=0)


def test_vit_state_dict_round_trip(weights):
    """JAX variables -> state dict -> strict load -> the port's state dict,
    key for key; the patch kernel lands as OpenAI's conv1 weight."""
    variables, sd = weights
    model = clip_from_state_dict(sd, name="small-vit", device="cpu")
    assert model.config == CLIPConfig(**SMALL_VIT)
    loaded = model.state_dict()
    assert set(loaded) == set(sd)
    for key, value in sd.items():
        assert torch.equal(loaded[key], torch.as_tensor(value)), key
    pk = np.asarray(variables["params"]["visual"]["patch_kernel"])
    conv = sd["visual.conv1.weight"]
    assert conv.shape == (128, 3, 16, 16)
    np.testing.assert_array_equal(conv.transpose(2, 3, 1, 0).reshape(-1, 128), pk)
    np.testing.assert_array_equal(model.visual.patch_kernel().numpy(), pk)


@pytest.mark.parametrize("name", ["ViT-B/32", "ViT-L/14@336px"])
def test_config_sniffed_from_zero_filled_state_dict(name):
    """The full architectures' state-dict shapes (a model on the meta device
    holds no memory) filled with zeros that take none either."""
    with torch.device("meta"):
        shapes = CLIP(get_config(name)).state_dict()
    sd = {k: np.broadcast_to(np.float32(0), tuple(v.shape)) for k, v in shapes.items()}
    assert config_from_state_dict(sd, name=name) == get_config(name)
    jcfg = jax_config_from_state_dict(sd, name=name)
    assert (jcfg.vision_layers, jcfg.vision_width, jcfg.vision_patch_size,
            jcfg.image_resolution, jcfg.embed_dim) == (
        get_config(name).vision_layers, get_config(name).vision_width,
        get_config(name).vision_patch_size, get_config(name).image_resolution,
        get_config(name).embed_dim)
