"""The combined CLIP model (port of ``models/clip.py``).

Reference ``clip/model.py`` ``CLIP`` (:243-372): ``encode_image`` /
``encode_text`` towers and the contrastive ``forward`` producing
temperature-scaled cosine-similarity logits.  The embedding-space head
(normalization and logits) always runs in f32 at full precision, even when
the towers compute in bf16.

:class:`CLIP` subclasses :class:`TextTransformer` so that its parameters
carry OpenAI's state-dict keys (the text tower at the top level, the image
tower under ``visual.``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from debiasing_multi_modal_tpu_torch.models.config import CLIPConfig, get_config
from debiasing_multi_modal_tpu_torch.models.layers import MultiHeadAttentionBlock
from debiasing_multi_modal_tpu_torch.models.resnet import AttentionPool2d, ModifiedResNet
from debiasing_multi_modal_tpu_torch.models.text import TextTransformer
from debiasing_multi_modal_tpu_torch.models.vit import VisionTransformer
from debiasing_multi_modal_tpu_torch.utils.platform import DeviceLike, resolve_device


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """x / ||x|| along ``dim`` in float32 (norm semantics of torch .norm)."""
    x32 = x.float()
    norm = torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=True))
    if eps:
        norm = torch.clamp(norm, min=eps)
    return (x32 / norm).to(x.dtype)


class CLIP(TextTransformer):
    def __init__(self, config: CLIPConfig, attn_impl: str = "auto",
                 quant: str = "none", fuse_qkv: bool = False, remat: bool = False):
        cfg = config
        if not cfg.is_vit and quant != "none":
            raise ValueError(
                "quant is ViT-only: the ResNet towers are conv-dominated, and "
                "the JAX package runs them unquantized too"
            )
        super().__init__(
            vocab_size=cfg.vocab_size, context_length=cfg.context_length,
            width=cfg.transformer_width, heads=cfg.transformer_heads,
            layers=cfg.transformer_layers, embed_dim=cfg.embed_dim,
            dtype=cfg.dtype, attn_impl=attn_impl, fuse_qkv=fuse_qkv, remat=remat,
        )
        self.config = cfg
        if cfg.is_vit:
            self.visual = VisionTransformer(
                input_resolution=cfg.image_resolution,
                patch_size=cfg.vision_patch_size, width=cfg.vision_width,
                layers=cfg.vision_layers, heads=cfg.vision_heads,
                output_dim=cfg.embed_dim, dtype=cfg.dtype, attn_impl=attn_impl,
                quant=quant, fuse_qkv=fuse_qkv, remat=remat,
            )
        else:
            self.visual = ModifiedResNet(
                layers=cfg.vision_layers, output_dim=cfg.embed_dim,
                heads=cfg.vision_heads, input_resolution=cfg.image_resolution,
                width=cfg.vision_width, dtype=cfg.dtype,
            )
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC ``[N, H, W, 3]`` CLIP-normalized floats -> un-normalized ``[N, D]``."""
        return self.visual(images)

    def forward(self, images: torch.Tensor,
                token_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # upcast BEFORE normalizing, so the normalized components are not
        # rounded to bf16 ahead of the f32 head
        img = l2_normalize(self.encode_image(images).float())
        txt = l2_normalize(self.encode_text(token_ids).float())
        logits_per_image = self.logit_scale.float().exp() * (img @ txt.T)
        return logits_per_image, logits_per_image.T


@torch.no_grad()
def init_weights(model: CLIP, generator: torch.Generator) -> None:
    """Seeded random weights at the real shapes, drawn on the CPU (so a seed
    gives the same weights on every device): lecun-normal projections and
    convolutions, zero biases, identity BatchNorms, and the reference's stds
    for the embeddings (clip/model.py:306-334)."""

    def normal_(p: torch.Tensor, std: float):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            normal_(module.weight, module.weight[0].numel() ** -0.5)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, MultiHeadAttentionBlock):
            normal_(module.in_proj_weight, module.in_proj_weight.shape[1] ** -0.5)
            module.in_proj_bias.zero_()
        elif isinstance(module, AttentionPool2d):
            pos = module.positional_embedding
            normal_(pos, pos.shape[1] ** -0.5)
        elif isinstance(module, VisionTransformer):
            # flax's initializers in the JAX tower: normal(width^-0.5)
            for p in (module.class_embedding, module.positional_embedding, module.proj):
                normal_(p, module.proj.shape[0] ** -0.5)
    width = model.text_projection.shape[0]
    normal_(model.token_embedding.weight, 0.02)
    normal_(model.positional_embedding, 0.01)
    normal_(model.text_projection, width ** -0.5)
    model.logit_scale.fill_(math.log(1 / 0.07))


def create_clip(name_or_config, dtype=None, attn_impl: str = "auto",
                remat: bool = False, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None,
                fuse_bn: bool = False, quant: str = "none",
                fuse_qkv: bool = False) -> CLIP:
    """A frozen CLIP model in eval mode on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for) with seeded random weights (``generator``,
    default seed 0).  Its parameters do not require grad: a caller that
    trains turns grad on (``model.requires_grad_(True)``).

    ``dtype=None`` keeps the config's compute dtype (f32 for zoo names); an
    explicit dtype is honored for both names and configs.  ``attn_impl`` and
    ``remat`` (rematerialized transformer blocks in the backward) are the
    JAX package's; ``quant`` is "none", "int8" (the plain integer product)
    or "int8_pallas" (kernel 7), ViT only and inference only, as in the JAX
    package; ``fuse_qkv`` feeds one fused in-projection GEMM to kernel 3.
    ``fuse_bn`` is not yet ported and raises."""
    if fuse_bn:
        raise NotImplementedError("fuse_bn=True is not yet ported")
    dev = resolve_device(device)
    if isinstance(name_or_config, CLIPConfig):
        cfg = name_or_config if dtype is None else name_or_config.with_dtype(dtype)
    else:
        cfg = get_config(name_or_config, dtype=torch.float32 if dtype is None else dtype)
    model = CLIP(cfg, attn_impl=attn_impl, quant=quant, fuse_qkv=fuse_qkv, remat=remat)
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    return model.to(dev).eval().requires_grad_(False)
