"""ModifiedResNet vision tower (port of ``models/resnet.py``).

Reference ``clip/model.py``: ``Bottleneck`` (:10-55, anti-aliased stride: an
average pool before the stride-1 conv3 and in the downsample path), the
3-conv stem with an average pool (:107-117), four stages (:121-124), and the
``AttentionPool2d`` head (:58-91): a learned (HW+1, C) positional embedding,
the mean token prepended as the single query, separate q/k/v projections and
``c_proj`` to ``output_dim``.

The public input is NHWC like the JAX tower's; inside, activations are NCHW
tensors in channels-last memory.  Convolutions are ``F.conv2d`` (the JAX
package leaves them to XLA, outside any kernel), computed in ``dtype`` with
the f32 weights cast at use, and in f32 never as TF32
(``utils/platform.full_f32``); BatchNorms apply their running statistics in f32
(:class:`InferenceBatchNorm`).  With ``fuse_bn`` (weights from
``weights/fold.py``) every conv carries a bias and no BatchNorm exists: the
conv output is rounded to ``dtype`` and the bias added in ``dtype``, as
flax's biased ``nn.Conv`` does.  The single-query attention pool uses the
plain attention formulation (``impl="xla"``), as the JAX tower pins.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from debiasing_multi_modal_tpu_torch.models.layers import InferenceBatchNorm, linear
from debiasing_multi_modal_tpu_torch.ops.attention import dot_product_attention
from debiasing_multi_modal_tpu_torch.utils.platform import full_f32


def _conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    y = F.conv2d(x.to(dtype), layer.weight.to(dtype), None, layer.stride,
                 layer.padding)
    if layer.bias is not None:  # folded BatchNorm: added in dtype, as flax
        y = y + layer.bias.to(dtype)[:, None, None]
    return y


def _conv_layer(cin: int, cout: int, kernel: int, stride: int = 1,
                bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                     bias=bias)


def _bn(features: int, fuse_bn: bool) -> nn.Module:
    """The BatchNorm after a conv, or nothing (no state-dict keys) when it is
    folded into the conv."""
    return nn.Identity() if fuse_bn else InferenceBatchNorm(features)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype=torch.float32, fuse_bn: bool = False):
        super().__init__()
        out_planes = planes * self.expansion
        self.dtype = dtype
        self.stride = stride
        self.conv1 = _conv_layer(inplanes, planes, 1, bias=fuse_bn)
        self.bn1 = _bn(planes, fuse_bn)
        self.conv2 = _conv_layer(planes, planes, 3, bias=fuse_bn)
        self.bn2 = _bn(planes, fuse_bn)
        self.conv3 = _conv_layer(planes, out_planes, 1, bias=fuse_bn)
        self.bn3 = _bn(out_planes, fuse_bn)
        self.downsample = None
        if stride > 1 or inplanes != out_planes:
            # OpenAI's keys: downsample.0 (conv), downsample.1 (BN)
            self.downsample = nn.ModuleList([
                _conv_layer(inplanes, out_planes, 1, bias=fuse_bn),
                _bn(out_planes, fuse_bn),
            ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = F.relu(self.bn1(_conv(x, self.conv1, dt)))
        out = F.relu(self.bn2(_conv(out, self.conv2, dt)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(_conv(out, self.conv3, dt))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            conv, bn = self.downsample
            identity = bn(_conv(identity, conv, dt))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """Single-query attention pooling over the final feature map."""

    def __init__(self, spatial: int, embed_dim: int, num_heads: int,
                 output_dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.empty(spatial ** 2 + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW ``[N, C, H, W]`` -> ``[N, output_dim]``."""
        n, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)  # [N, HW, C], row-major over (h, w)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)
        dt = self.dtype
        c = self.q_proj.out_features  # C, or C/tp for a tensor-parallel shard
        hd = c // self.num_heads
        # the mean token is the only query: [N, 1, C] against HW+1 keys
        q = linear(tokens[:, :1], self.q_proj, dt)
        k = linear(tokens, self.k_proj, dt)
        v = linear(tokens, self.v_proj, dt)
        out = dot_product_attention(
            q.reshape(n, 1, self.num_heads, hd),
            k.reshape(n, -1, self.num_heads, hd),
            v.reshape(n, -1, self.num_heads, hd),
            impl="xla",
        ).reshape(n, 1, c)
        return linear(out, self.c_proj, dt)[:, 0]


class ModifiedResNet(nn.Module):
    def __init__(self, layers: Tuple[int, int, int, int], output_dim: int,
                 heads: int, input_resolution: int = 224, width: int = 64,
                 dtype=torch.float32, fuse_bn: bool = False):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv_layer(3, width // 2, 3, stride=2, bias=fuse_bn)
        self.bn1 = _bn(width // 2, fuse_bn)
        self.conv2 = _conv_layer(width // 2, width // 2, 3, bias=fuse_bn)
        self.bn2 = _bn(width // 2, fuse_bn)
        self.conv3 = _conv_layer(width // 2, width, 3, bias=fuse_bn)
        self.bn3 = _bn(width, fuse_bn)
        inplanes = width
        for stage, (mult, blocks) in enumerate(zip((1, 2, 4, 8), layers), start=1):
            planes = width * mult
            stage_blocks = []
            for block in range(blocks):
                stride = 2 if (block == 0 and stage > 1) else 1
                stage_blocks.append(Bottleneck(inplanes, planes, stride, dtype, fuse_bn))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*stage_blocks))
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32,
                                        heads, output_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC ``[N, H, W, 3]`` CLIP-normalized floats -> ``[N, output_dim]``.

        An f32 tower runs in full f32, as the JAX reference does, even where
        cuDNN's process-wide TF32 switch is on (PyTorch's default)."""
        dt = self.dtype
        with full_f32() if dt == torch.float32 else contextlib.nullcontext():
            x = x.to(dt).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            x = F.relu(self.bn1(_conv(x, self.conv1, dt)))
            x = F.relu(self.bn2(_conv(x, self.conv2, dt)))
            x = F.relu(self.bn3(_conv(x, self.conv3, dt)))
            x = F.avg_pool2d(x, 2)
            for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
                x = stage(x)
            return self.attnpool(x)
