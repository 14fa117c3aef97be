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
    """``fuse_qkv`` builds now (on every transformer, a ResNet's text tower
    included); ``quant`` on a ResNet raises ``ValueError``, as in the JAX
    package."""
    import pytest

    from debiasing_multi_modal_tpu_torch.models import CLIPConfig, create_clip

    cfg = CLIPConfig(name="tiny", embed_dim=32, image_resolution=32,
                     vision_layers=(1, 1, 1, 1), vision_width=8,
                     vision_patch_size=None, transformer_width=128,
                     transformer_heads=2, transformer_layers=1)
    model = create_clip(cfg, device="cpu", fuse_qkv=True)
    assert model.transformer.resblocks[0].attn.fuse_qkv
    with pytest.raises(ValueError, match="quant"):
        create_clip(cfg, device="cpu", quant="int8")


def _block_pair(seed, **kw):
    block = jl.ResidualAttentionBlock(num_heads=2, **kw)
    x = _x((3, 50, 128), seed=seed)
    params = block.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    sd = transformer_state_dict_from_jax({"resblocks_0": params})
    ours = tl.ResidualAttentionBlock(128, 2, causal=kw.get("causal", False),
                                     quant=kw.get("quant", "none"),
                                     fuse_qkv=kw.get("fuse_qkv", False))
    ours.load_state_dict({k[len("resblocks.0."):]: torch.from_numpy(v)
                          for k, v in sd.items()}, strict=True)
    ref = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = ours(torch.from_numpy(x)).numpy()
    return out, ref


def test_fused_qkv_block_matches_flax():
    """``fuse_qkv``: one [D, 3D] GEMM into the packed attention, in both
    packages; the parameters stay the unfused ones."""
    out, ref = _block_pair(6, causal=True, fuse_qkv=True)
    np.testing.assert_allclose(out, ref, **TOL)


def test_quantized_mlp_matches_flax():
    """The W8A8 MLP on one input: c_fc's int8 operands are bit-equal to
    JAX's, so its output agrees to f32 ulps; c_proj quantizes QuickGELU's
    output, where a last-bit difference can move one int8 element by one
    step (1/127 of its row's maximum): within 2/127 of the output's scale,
    and at least 99 % of the elements within 1e-5 of it."""
    x = _x((4, 50, 128), seed=7)
    for quant in ("int8", "int8_pallas"):
        mlp = jl.MLPBlock(quant=quant)
        params = mlp.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
        ref = np.asarray(mlp.apply({"params": params}, jnp.asarray(x)))
        ours = tl.MLPBlock(128, quant=quant)
        ours.load_state_dict({
            f"{n}.{k}": torch.from_numpy(np.array(v).T if k == "weight" else np.array(v))
            for n in ("c_fc", "c_proj")
            for k, v in (("weight", params[n]["kernel"]), ("bias", params[n]["bias"]))
        }, strict=True)
        assert isinstance(ours.c_fc, tl.Int8Dense)
        with torch.no_grad():
            out = ours(torch.from_numpy(x)).numpy()
        scale = np.abs(ref).max()
        np.testing.assert_allclose(out, ref, rtol=0, atol=2 / 127 * scale)
        assert (np.abs(out - ref) <= 1e-5 * scale).mean() >= 0.99
