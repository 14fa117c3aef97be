"""Text transformer tower (port of ``models/text.py``).

Reference ``clip/model.py`` ``encode_text`` (:343-356): token embedding plus
learned positional embedding, a causally masked transformer, the final
LayerNorm, and the feature at the EOT token — located by ``argmax`` over the
token ids, valid because EOT (49407) is the highest id in every sequence —
projected by ``text_projection``.  The causal mask is built inside the
attention kernel; no 77x77 buffer exists.

Parameter names are OpenAI's top-level ones (``token_embedding.weight``,
``positional_embedding``, ``transformer.resblocks.*``, ``ln_final``,
``text_projection``): :class:`~debiasing_multi_modal_tpu_torch.models.clip.CLIP`
is a ``TextTransformer`` with a vision tower added, as OpenAI's CLIP holds
the text tower's parameters at its top level.  ``fuse_qkv`` runs each
block's q/k/v projections as one GEMM into kernel 3 (``models/layers.py``);
the text tower is never quantized, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from debiasing_multi_modal_tpu_torch.models.layers import LayerNormF32, Transformer


class TextTransformer(nn.Module):
    def __init__(self, vocab_size: int, context_length: int, width: int,
                 heads: int, layers: int, embed_dim: int,
                 dtype=torch.float32, attn_impl: str = "auto",
                 fuse_qkv: bool = False):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = Transformer(width, layers, heads, causal=True,
                                       dtype=dtype, attn_impl=attn_impl,
                                       fuse_qkv=fuse_qkv)
        self.ln_final = LayerNormF32(width)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def encode_text(self, token_ids: torch.Tensor) -> torch.Tensor:
        """Integer ``[N, context_length]`` -> un-normalized ``[N, embed_dim]``."""
        token_ids = token_ids.long()
        x = self.token_embedding(token_ids).to(self.dtype)
        x = x + self.positional_embedding.to(self.dtype)
        x = self.ln_final(self.transformer(x))
        eot = token_ids.argmax(dim=-1)
        feats = x[torch.arange(x.shape[0], device=x.device), eot]
        return feats @ self.text_projection.to(self.dtype)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.encode_text(token_ids)
