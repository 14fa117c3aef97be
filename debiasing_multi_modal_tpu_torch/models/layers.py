"""Shared layers for the CLIP towers (port of ``models/layers.py``).

Numerics policy, as in the JAX package: parameters stay f32; activations are
computed in the module's ``dtype`` (bf16 on the card), each layer casting its
weights to that dtype at use, as flax ``Dense(dtype=bf16)`` does; every
normalization computes its statistics in f32.  Parameter names follow
OpenAI's CLIP state dict, so a converted or real checkpoint loads with
``load_state_dict``.

``quant`` ("none", "int8", "int8_pallas") swaps every transformer Dense for
the W8A8 :class:`~debiasing_multi_modal_tpu_torch.ops.quant.Int8Dense` with
the same parameters; ``fuse_qkv`` computes the q/k/v projections as one
``[D, 3D]`` GEMM on ``in_proj_weight`` and feeds the packed slab to kernel 3.
``fuse_qkv`` with a ``quant`` other than "none" takes the unfused path, as
the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from debiasing_multi_modal_tpu_torch.ops.attention import (
    multi_head_attention,
    multi_head_attention_packed,
)
from debiasing_multi_modal_tpu_torch.ops.quant import Int8Dense, int8_dense

QUANT_MODES = ("none", "int8", "int8_pallas")


def quant_impl(quant: str) -> str:
    """Map a model-level quant mode to the int8_dense GEMM impl."""
    return "pallas" if quant == "int8_pallas" else "xla"


def make_dense(in_features: int, out_features: int, *, dtype,
               quant: str) -> nn.Linear:
    """``nn.Linear`` or its W8A8 drop-in, by ``quant`` mode; the parameters
    are the same either way, so converted checkpoints load into both.
    ``quant`` is validated here, so a typo fails when the model is built."""
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}; known: {QUANT_MODES}")
    if quant == "none":
        return nn.Linear(in_features, out_features)
    return Int8Dense(in_features, out_features, out_dtype=dtype,
                     impl=quant_impl(quant))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) — reference clip/model.py:166-168."""
    return x * torch.sigmoid(1.702 * x)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype`` with its f32 parameters cast at use;
    an :class:`Int8Dense` runs its own W8A8 path (quantizing ``x`` as it
    comes, as the JAX package's ``Int8Dense`` does)."""
    if isinstance(layer, Int8Dense):
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class LayerNormF32(nn.LayerNorm):
    """LayerNorm computed in float32 and cast back to the input dtype."""

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__(width, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                           self.bias, self.eps)
        return out.to(x.dtype)


class InferenceBatchNorm(nn.Module):
    """BatchNorm that always uses its stored running statistics, in f32.

    The CLIP encoders are frozen feature extractors, so each BatchNorm is an
    affine map of its running statistics.  Keys match ``nn.BatchNorm2d``
    (weight, bias, running_mean, running_var, num_batches_tracked); the
    channel axis is 1 (NCHW)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * inv
        out = x.float() * inv[:, None, None] + shift[:, None, None]
        return out.to(x.dtype)


class MultiHeadAttentionBlock(nn.Module):
    """Self-attention over ``[B, S, D]`` with OpenAI's ``nn.MultiheadAttention``
    parameter layout (``in_proj_weight [3D, D]``, ``in_proj_bias``,
    ``out_proj``).  By default the q/k/v projections run unfused, one GEMM
    each on the row blocks of ``in_proj_weight``, as the JAX package's
    default does; ``fuse_qkv`` runs them as one ``[D, 3D]`` GEMM whose packed
    output feeds :func:`multi_head_attention_packed` directly."""

    def __init__(self, width: int, num_heads: int, dtype=torch.float32,
                 attn_impl: str = "auto", quant: str = "none",
                 fuse_qkv: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.quant = quant
        self.fuse_qkv = fuse_qkv
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = make_dense(width, width, dtype=dtype, quant=quant)

    def forward(self, x: torch.Tensor, *, causal: bool = False) -> torch.Tensor:
        d = x.shape[-1]
        if self.quant != "none":
            impl = quant_impl(self.quant)
            q, k, v = (int8_dense(x, self.in_proj_weight[i * d:(i + 1) * d].t(),
                                  self.in_proj_bias[i * d:(i + 1) * d],
                                  out_dtype=self.dtype, impl=impl)
                       for i in range(3))
        else:
            xd = x.to(self.dtype)
            w = self.in_proj_weight.to(self.dtype)
            b = self.in_proj_bias.to(self.dtype)
            if self.fuse_qkv:
                qkv = F.linear(xd, w, b)  # [B, S, 3D]: q | k | v
                out = multi_head_attention_packed(qkv, self.num_heads, causal=causal,
                                                  impl=self.attn_impl)
                return linear(out, self.out_proj, self.dtype)
            q, k, v = (F.linear(xd, w[i * d:(i + 1) * d], b[i * d:(i + 1) * d])
                       for i in range(3))
        out = multi_head_attention(q, k, v, self.num_heads, causal=causal,
                                   impl=self.attn_impl)
        return linear(out, self.out_proj, self.dtype)


class MLPBlock(nn.Module):
    """c_fc -> QuickGELU -> c_proj (reference clip/model.py:177-181)."""

    def __init__(self, width: int, expansion: int = 4, dtype=torch.float32,
                 quant: str = "none"):
        super().__init__()
        self.dtype = dtype
        self.c_fc = make_dense(width, width * expansion, dtype=dtype, quant=quant)
        self.c_proj = make_dense(width * expansion, width, dtype=dtype, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = quick_gelu(linear(x, self.c_fc, self.dtype))
        return linear(h, self.c_proj, self.dtype)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block with QuickGELU MLP (clip/model.py:171-192)."""

    def __init__(self, width: int, num_heads: int, causal: bool = False,
                 dtype=torch.float32, attn_impl: str = "auto",
                 quant: str = "none", fuse_qkv: bool = False):
        super().__init__()
        self.causal = causal
        self.attn = MultiHeadAttentionBlock(width, num_heads, dtype, attn_impl,
                                            quant=quant, fuse_qkv=fuse_qkv)
        self.ln_1 = LayerNormF32(width)
        self.mlp = MLPBlock(width, dtype=dtype, quant=quant)
        self.ln_2 = LayerNormF32(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal=self.causal)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    """Stack of residual attention blocks (``resblocks.{i}``)."""

    def __init__(self, width: int, layers: int, heads: int,
                 causal: bool = False, dtype=torch.float32,
                 attn_impl: str = "auto", quant: str = "none",
                 fuse_qkv: bool = False):
        super().__init__()
        self.width = width
        self.resblocks = nn.Sequential(*(
            ResidualAttentionBlock(width, heads, causal, dtype, attn_impl,
                                   quant=quant, fuse_qkv=fuse_qkv)
            for _ in range(layers)
        ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.width:
            raise ValueError(
                f"input width {x.shape[-1]} != configured width {self.width}"
            )
        return self.resblocks(x)
