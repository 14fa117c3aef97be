"""The port's layers (debiasing_multi_modal_tpu_torch/models/layers.py)
against the JAX package's flax layers on the same inputs and weights, f32 on
the CPU.  Tolerance 1e-5: the same f32 math in another reduction order."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from debiasing_multi_modal_tpu.models import layers as jl
from debiasing_multi_modal_tpu_torch.models import layers as tl
from debiasing_multi_modal_tpu_torch.weights.convert import (
    transformer_state_dict_from_jax,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_quick_gelu():
    x = _x((4, 33), seed=1) * 4
    np.testing.assert_allclose(
        tl.quick_gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jl.quick_gelu(jnp.asarray(x))), **TOL,
    )


def test_layernorm_f32():
    x = _x((3, 7, 128), seed=2) * 3 + 1
    rng = np.random.default_rng(3)
    scale = rng.standard_normal(128).astype(np.float32)
    bias = rng.standard_normal(128).astype(np.float32)
    ref = jl.LayerNormF32().apply(
        {"params": {"ln": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}},
        jnp.asarray(x),
    )
    ln = tl.LayerNormF32(128)
    ln.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), **TOL)


def test_layernorm_keeps_bf16_dtype():
    x = torch.from_numpy(_x((2, 5, 128))).bfloat16()
    assert tl.LayerNormF32(128)(x).dtype == torch.bfloat16


def _flax_transformer(layers, causal):
    model = jl.Transformer(width=128, layers=layers, heads=2)
    x = _x((3, 77, 128), seed=4)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x), causal=causal)["params"]
    return model, params, x


def test_residual_block_matches_flax():
    block = jl.ResidualAttentionBlock(num_heads=2, causal=True)
    x = _x((3, 77, 128), seed=5)
    params = block.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    ref = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    sd = transformer_state_dict_from_jax({"resblocks_0": params})
    ours = tl.ResidualAttentionBlock(128, 2, causal=True)
    ours.load_state_dict({k[len("resblocks.0."):]: torch.from_numpy(v)
                          for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = ours(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_residual_block_bf16_matches_flax():
    """The block at dtype=bf16 in both packages on one bf16 input: within 2
    bf16 ulps of the output's scale, and at least half the elements
    bit-equal (the roundings sit in the same places)."""
    x = jnp.asarray(_x((3, 77, 128), seed=5), jnp.bfloat16)
    block = jl.ResidualAttentionBlock(num_heads=2, causal=True, dtype=jnp.bfloat16)
    params = block.init(jax.random.PRNGKey(1), x)["params"]
    ref = block.apply({"params": params}, x)
    sd = transformer_state_dict_from_jax({"resblocks_0": params})
    ours = tl.ResidualAttentionBlock(128, 2, causal=True, dtype=torch.bfloat16)
    ours.load_state_dict({k[len("resblocks.0."):]: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = ours(torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16())
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    ref = np.asarray(ref).astype(np.float32)
    out = out.float().numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2 * 2.0 ** -8 * np.abs(ref).max())
    assert (out == ref).mean() >= 0.5


def test_two_layer_causal_transformer_matches_flax():
    model, params, x = _flax_transformer(2, causal=True)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x), causal=True))
    ours = tl.Transformer(128, 2, 2, causal=True)
    ours.load_state_dict({k: torch.from_numpy(v) for k, v in
                          transformer_state_dict_from_jax(params).items()}, strict=True)
    with torch.no_grad():
        out = ours(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_not_yet_ported_options_raise():
    import pytest

    from debiasing_multi_modal_tpu_torch.models import CLIPConfig, create_clip

    cfg = CLIPConfig(name="tiny", embed_dim=32, image_resolution=32,
                     vision_layers=(1, 1, 1, 1), vision_width=8,
                     vision_patch_size=None, transformer_width=128,
                     transformer_heads=2, transformer_layers=1)
    with pytest.raises(NotImplementedError, match="fuse_qkv"):
        create_clip(cfg, device="cpu", fuse_qkv=True)
    with pytest.raises(NotImplementedError, match="quant"):
        create_clip(cfg, device="cpu", quant="int8")
