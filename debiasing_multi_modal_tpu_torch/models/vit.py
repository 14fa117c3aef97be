"""Vision Transformer tower (port of ``models/vit.py``).

Reference ``clip/model.py`` ``VisionTransformer`` (:206-240): patch-conv
embed (no bias), class token plus learned positional embedding, pre- and
post-LayerNorm, output projection from the class token.  Parameter names are
OpenAI's (``conv1.weight [W, 3, P, P]``, ``class_embedding``,
``positional_embedding``, ``ln_pre``, ``transformer.resblocks.*``,
``ln_post``, ``proj``).

As in the JAX tower, the patch convolution is one GEMM: the NHWC image is cut
into ``[N, gh*gw, P*P*C]`` patches flattened in (row, col, channel) order,
against ``conv1.weight`` laid out as the ``(P, P, C, W)`` kernel flattened
the same way; the layout is batch-major ``[N, S, D]`` throughout.

``quant`` runs every transformer Dense on the W8A8 path; the patch GEMM and
the class-token projection stay in the activation dtype, as in the JAX tower
(``models/vit.py:31-41``).  ``remat`` rematerializes each block in the
backward (``models/layers.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from debiasing_multi_modal_tpu_torch.models.layers import LayerNormF32, Transformer


class VisionTransformer(nn.Module):
    def __init__(self, input_resolution: int, patch_size: int, width: int,
                 layers: int, heads: int, output_dim: int, dtype=torch.float32,
                 attn_impl: str = "auto", quant: str = "none",
                 fuse_qkv: bool = False, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        grid = input_resolution // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNormF32(width)
        self.transformer = Transformer(width, layers, heads, dtype=dtype,
                                       attn_impl=attn_impl, quant=quant,
                                       fuse_qkv=fuse_qkv, remat=remat)
        self.ln_post = LayerNormF32(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def patch_kernel(self) -> torch.Tensor:
        """``conv1.weight [W, C, P, P]`` as the ``[P*P*C, W]`` GEMM kernel
        (the JAX tower's ``patch_kernel``)."""
        w = self.conv1.weight
        return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC ``[N, H, W, 3]`` CLIP-normalized floats -> ``[N, output_dim]``."""
        n, h, w, c = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = x.to(self.dtype)
        patches = x.reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(n, gh * gw, p * p * c)
        tokens = patches @ self.patch_kernel().to(self.dtype)
        width = tokens.shape[-1]
        cls = self.class_embedding.to(self.dtype).expand(n, 1, width)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(self.dtype)
        tokens = self.transformer(self.ln_pre(tokens))
        cls_out = self.ln_post(tokens[:, 0])
        return cls_out @ self.proj.to(cls_out.dtype)
