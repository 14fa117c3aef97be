"""CLIP architecture configurations (port of ``models/config.py``).

A ResNet tower is selected when ``vision_layers`` is a tuple, a ViT tower
when it is an int (reference ``build_model``, clip/model.py:399-436).  The
registry covers the public OpenAI model zoo; checkpoints are still
shape-sniffed at conversion time (weights/convert.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    embed_dim: int
    # vision
    image_resolution: int
    vision_layers: Union[Tuple[int, int, int, int], int]
    vision_width: int
    vision_patch_size: Optional[int]
    # text
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    # numerics policy: compute dtype (bf16 on the card); params stay f32
    dtype: torch.dtype = torch.float32

    @property
    def is_vit(self) -> bool:
        return isinstance(self.vision_layers, int)

    @property
    def vision_heads(self) -> int:
        if self.is_vit:
            return self.vision_width // 64
        return self.vision_width * 32 // 64

    @property
    def image_seq_len(self) -> int:
        """Token count seen by the vision transformer / attention pool."""
        if self.is_vit:
            return (self.image_resolution // self.vision_patch_size) ** 2 + 1
        return (self.image_resolution // 32) ** 2 + 1

    def with_dtype(self, dtype) -> "CLIPConfig":
        return dataclasses.replace(self, dtype=dtype)


def _rn(name, embed, layers, width, res, twidth, theads, tlayers=12):
    return CLIPConfig(
        name=name, embed_dim=embed, image_resolution=res,
        vision_layers=layers, vision_width=width, vision_patch_size=None,
        transformer_width=twidth, transformer_heads=theads,
        transformer_layers=tlayers,
    )


def _vit(name, embed, layers, width, patch, res, twidth, theads, tlayers=12):
    return CLIPConfig(
        name=name, embed_dim=embed, image_resolution=res,
        vision_layers=layers, vision_width=width, vision_patch_size=patch,
        transformer_width=twidth, transformer_heads=theads,
        transformer_layers=tlayers,
    )


CONFIGS: Dict[str, CLIPConfig] = {
    "RN50": _rn("RN50", 1024, (3, 4, 6, 3), 64, 224, 512, 8),
    "RN101": _rn("RN101", 512, (3, 4, 23, 3), 64, 224, 512, 8),
    "RN50x4": _rn("RN50x4", 640, (4, 6, 10, 6), 80, 288, 640, 10),
    "RN50x16": _rn("RN50x16", 768, (6, 8, 18, 8), 96, 384, 768, 12),
    "RN50x64": _rn("RN50x64", 1024, (3, 15, 36, 10), 128, 448, 1024, 16),
    "ViT-B/32": _vit("ViT-B/32", 512, 12, 768, 32, 224, 512, 8),
    "ViT-B/16": _vit("ViT-B/16", 512, 12, 768, 16, 224, 512, 8),
    "ViT-L/14": _vit("ViT-L/14", 768, 24, 1024, 14, 224, 768, 12),
    "ViT-L/14@336px": _vit("ViT-L/14@336px", 768, 24, 1024, 14, 336, 768, 12),
}


def get_config(name: str, dtype=torch.float32) -> CLIPConfig:
    try:
        return CONFIGS[name].with_dtype(dtype)
    except KeyError:
        raise ValueError(f"unknown CLIP model {name!r}; known: {sorted(CONFIGS)}") from None
