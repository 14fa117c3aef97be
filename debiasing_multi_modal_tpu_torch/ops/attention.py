"""Multi-head attention dispatch (port of ``ops/attention.py``).

The implementations, by ``impl``:

- ``"xla"``: the plain formulation of the JAX package's ``_xla_attention``.
  Logits are stored in the activation dtype (one rounding after the f32
  accumulation), the softmax runs in f32, the probabilities are cast to the
  value dtype and P.V accumulates in f32.  For f32 inputs this is all-f32.
- ``"short"``: the merged-head kernels
  (:mod:`debiasing_multi_modal_tpu_torch.ops.short_attention`): kernel 1
  (whole-row) where its block fits, else kernel 2 (q-tiled), else a raise.
- ``"pallas"``: the blockwise flash kernels
  (:mod:`debiasing_multi_modal_tpu_torch.ops.flash_attention`): kernel 4
  forward, kernels 5 and 6 backward; the plain versions on the CPU.
- ``"auto"``: on a CUDA tensor the chain of the JAX package's fall-through,
  always a kernel: :func:`multi_head_attention` takes kernel 1, else kernel
  2 (where :func:`short_attention.supported` holds); otherwise it splits
  the heads and :func:`dot_product_attention` takes kernel 4 (where
  :func:`flash_attention.supported` holds); otherwise it raises.  The card
  never drops to the plain formulation unasked, so the JAX package's TPU
  thresholds (``MIN_AUTO_SEQ_LEN``, ``SCORE_BYTES_THRESHOLD``) do not carry
  over: kernel 4 takes every shape the short kernels refuse.  On the CPU
  ``auto`` is the plain formulation, as the JAX package takes XLA off the
  TPU.  A mask raises on every kernel route.

:func:`multi_head_attention_packed` takes the fused in-projection's packed
``[B, S, 3D]`` slab: kernel 3 where its whole-row block fits (``"short"``,
or ``"auto"`` on the card), else it splits the slab and follows
:func:`multi_head_attention`, as the JAX package does.

Kernels 1-3 are differentiable: their backward is the VJP of the plain
merged-head formulation, as in the JAX package (``short_attention.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from debiasing_multi_modal_tpu_torch.ops import flash_attention as fa
from debiasing_multi_modal_tpu_torch.ops import short_attention as sa

_IMPLS = ("auto", "xla", "short", "pallas")


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, mask: Optional[torch.Tensor] = None,
                          causal: bool = False, impl: str = "auto") -> torch.Tensor:
    """Scaled dot-product attention over head-split inputs
    ``[batch, len, heads, head_dim]``; ``mask`` is additive, broadcastable to
    ``[batch, heads, q_len, kv_len]``."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; known: {_IMPLS}")
    if impl == "auto":
        impl = "xla" if q.device.type == "cpu" else "pallas"
    if impl == "pallas":
        return fa.flash_attention(q, k, v, mask=mask, causal=causal)
    return _xla_attention(q, k, v, mask=mask, causal=causal)


def _xla_attention(q, k, v, *, mask=None, causal=False):
    orig_dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)  # stored in the activation dtype
    logits = logits * scale
    if causal:
        q_len, kv_len = q.shape[1], k.shape[1]
        keep = torch.ones(q_len, kv_len, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    weights = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
    return out.to(orig_dtype)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, *, mask: Optional[torch.Tensor] = None,
                         causal: bool = False, impl: str = "auto") -> torch.Tensor:
    """Attention over merged-head inputs ``[batch, seq, model_dim]``."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; known: {_IMPLS}")
    if impl == "auto" and q.device.type != "cpu" and sa.supported(
            q, k, v, num_heads, mask=mask):
        impl = "short"
    if impl == "short":
        if mask is not None:
            raise ValueError("additive masks use the xla path")
        return sa.short_attention(q, k, v, num_heads, causal=causal)
    b, sq, d = q.shape
    skv = k.shape[1]
    hd = d // num_heads
    out = dot_product_attention(
        q.reshape(b, sq, num_heads, hd), k.reshape(b, skv, num_heads, hd),
        v.reshape(b, skv, num_heads, hd), mask=mask, causal=causal, impl=impl,
    )
    return out.reshape(b, sq, d)


def multi_head_attention_packed(qkv: torch.Tensor, num_heads: int, *,
                                causal: bool = False,
                                impl: str = "auto") -> torch.Tensor:
    """Attention over the packed ``[batch, seq, 3 * model_dim]`` slab (q | k
    | v along the last axis, the fused in-projection's output).  Kernel 3
    reads the slab in place when it takes the shape; every other case splits
    here and follows :func:`multi_head_attention`'s dispatch."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; known: {_IMPLS}")
    on_card = qkv.device.type == "cuda"
    if (impl == "short" or (impl == "auto" and on_card)) and (
            sa.supported_packed(qkv, num_heads)):
        return sa.short_attention_packed(qkv, num_heads, causal=causal)
    q, k, v = qkv.chunk(3, dim=-1)
    if on_card:  # the kernels read contiguous [B, S, D] slabs
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return multi_head_attention(q, k, v, num_heads, causal=causal, impl=impl)
