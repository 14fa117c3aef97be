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
from debiasing_multi_modal_tpu_torch.models.layers import (
    InferenceBatchNorm,
    MultiHeadAttentionBlock,
)
from debiasing_multi_modal_tpu_torch.models.resnet import (
    AttentionPool2d,
    Bottleneck,
    ModifiedResNet,
)
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
                 quant: str = "none", fuse_qkv: bool = False, remat: bool = False,
                 fuse_bn: bool = False):
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
                width=cfg.vision_width, dtype=cfg.dtype, fuse_bn=fuse_bn,
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
    convolutions, zero biases (the folded convs' too), identity BatchNorms,
    and the reference's stds
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


SCRATCH_INITS = ("flax", "reference")


@torch.no_grad()
def reference_scratch_init(model: CLIP, generator: torch.Generator) -> None:
    """Re-draw, in place, the tensors the reference's
    ``CLIP.initialize_parameters`` (clip/model.py:306-334) draws with its own
    stds, as the JAX package's ``reference_scratch_init`` does:

    - token embedding ~ N(0, 0.02), text positional embedding ~ N(0, 0.01);
    - ResNet attention pool q/k/v/c projections ~ N(0, c_proj.in_features^-0.5)
      and every Bottleneck's bn3 weight zeroed (residual branches start as
      identity);
    - text blocks: attention in-projection ~ N(0, width^-0.5), attention out
      and MLP c_proj ~ N(0, width^-0.5 * (2 * layers)^-0.5), MLP c_fc ~
      N(0, (2 * width)^-0.5); text projection ~ N(0, width^-0.5).

    The ViT tower keeps its draws (the reference loops over the text
    transformer only); every other tensor keeps :func:`init_weights`'s.
    Draws are made on the CPU from ``generator``."""

    def normal_(p: torch.Tensor, std: float):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    normal_(model.token_embedding.weight, 0.02)
    normal_(model.positional_embedding, 0.01)
    width = model.positional_embedding.shape[1]
    blocks = model.transformer.resblocks
    attn_std = width ** -0.5
    proj_std = width ** -0.5 * (2 * len(blocks)) ** -0.5
    fc_std = (2 * width) ** -0.5
    for blk in blocks:
        normal_(blk.attn.in_proj_weight, attn_std)
        normal_(blk.attn.out_proj.weight, proj_std)
        normal_(blk.mlp.c_fc.weight, fc_std)
        normal_(blk.mlp.c_proj.weight, proj_std)
    normal_(model.text_projection, attn_std)
    if isinstance(model.visual, ModifiedResNet):
        pool = model.visual.attnpool
        std = pool.c_proj.in_features ** -0.5
        for proj in (pool.q_proj, pool.k_proj, pool.v_proj, pool.c_proj):
            normal_(proj.weight, std)
        for block in model.visual.modules():
            if isinstance(block, Bottleneck) and isinstance(block.bn3, InferenceBatchNorm):
                block.bn3.weight.zero_()


def create_clip(name_or_config, dtype=None, attn_impl: str = "auto",
                remat: bool = False, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None,
                fuse_bn: bool = False, quant: str = "none",
                fuse_qkv: bool = False, scratch_init: str = "flax") -> CLIP:
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
    ``fuse_bn`` builds the ResNet tower with its BatchNorms folded into the
    convs (biased convs, no BatchNorm modules: load weights from
    ``weights/fold.py``); a ViT ignores it, as in the JAX package.
    ``scratch_init="reference"`` then re-draws the tensors the reference's
    own init scheme covers (:func:`reference_scratch_init`, from the same
    generator); the default ``"flax"`` keeps :func:`init_weights`'s draws."""
    if scratch_init not in SCRATCH_INITS:
        raise ValueError(f"unknown scratch_init {scratch_init!r}; known: {SCRATCH_INITS}")
    dev = resolve_device(device)
    if isinstance(name_or_config, CLIPConfig):
        cfg = name_or_config if dtype is None else name_or_config.with_dtype(dtype)
    else:
        cfg = get_config(name_or_config, dtype=torch.float32 if dtype is None else dtype)
    model = CLIP(cfg, attn_impl=attn_impl, quant=quant, fuse_qkv=fuse_qkv, remat=remat,
                 fuse_bn=fuse_bn)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    init_weights(model, gen)
    if scratch_init == "reference":
        reference_scratch_init(model, gen)
    return model.to(dev).eval().requires_grad_(False)
