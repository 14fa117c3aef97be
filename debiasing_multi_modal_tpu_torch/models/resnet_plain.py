"""Standard (torchvision-style) ResNet for from-scratch / SupCon training
(port of ``models/resnet_plain.py``).

Parity surface: reference ``workspace/jinsu/resnet.py`` (:112-220) — the
legacy SupCon workspace's ResNet-50: 7x7 stride-2 stem + max pool, standard
stride-2 bottlenecks (no CLIP anti-aliasing), global average pool.  Unlike
the frozen CLIP towers this encoder is trainable: its BatchNorms normalize
with the batch's statistics in training mode and update running ones.

The BatchNorm is flax's (:class:`FlaxBatchNorm2d`), which the JAX module
uses, not ``nn.BatchNorm2d``: the batch variance is the biased one,
``mean(x^2) - mean(x)^2`` clamped at 0, both to normalize and to update the
running variance (torch updates with the unbiased one), with flax's
momentum 0.9 on the old value (torch's 0.1 on the new), epsilon 1e-5, all
in f32 (f64 for an f64 model).  Keys are ``nn.BatchNorm2d``'s.  Inputs are NHWC ``[N, H, W, 3]``
as in the JAX module; the convolutions run NCHW in ``dtype``, f32 ones
under ``utils/platform.full_f32`` (no TF32).  Convolutions start from
kaiming-normal (fan_out, ReLU) weights drawn from a ``generator``
(reference :148-150, the JAX module's ``variance_scaling(2, "fan_out")``).

Not wired into the debiasing pipeline (the reference's workspace is not
either); exposed for the linear-evaluation harness (``train/linear_eval.py``).
``weights/convert.py::plain_resnet_state_dict_from_jax`` carries the JAX
module's ``params`` and ``batch_stats`` across.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from debiasing_multi_modal_tpu_torch.utils.platform import full_f32


class FlaxBatchNorm2d(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW channels
    (module docstring); the output is f32 (f64 for an f64 input)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))  # f32 or wider, as flax
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.to(x.dtype)
        y = (x - mean[:, None, None]) * mul[:, None, None]
        return y + self.bias.to(x.dtype)[:, None, None]


def _kaiming(conv: nn.Conv2d, generator: Optional[torch.Generator]) -> nn.Conv2d:
    out_ch, _, kh, kw = conv.weight.shape
    std = (2.0 / (out_ch * kh * kw)) ** 0.5
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator) * std)
    return conv


def _conv(cin: int, cout: int, k: int, stride: int, generator) -> nn.Conv2d:
    return _kaiming(nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False),
                    generator)


class PlainBottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_planes = planes * self.expansion
        self.dtype = dtype
        self.conv1 = _conv(inplanes, planes, 1, 1, generator)
        self.bn1 = FlaxBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, generator)
        self.bn2 = FlaxBatchNorm2d(planes)
        self.conv3 = _conv(planes, out_planes, 1, 1, generator)
        self.bn3 = FlaxBatchNorm2d(out_planes)
        self.downsample = None
        if stride != 1 or inplanes != out_planes:
            self.downsample = nn.Sequential(_conv(inplanes, out_planes, 1, stride, generator),
                                            FlaxBatchNorm2d(out_planes))

    def _c(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype), None, conv.stride,
                        conv.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self._c(self.conv1, x)))
        out = F.relu(self.bn2(self._c(self.conv2, out)))
        out = self.bn3(self._c(self.conv3, out))
        if self.downsample is not None:
            x = self.downsample[1](self._c(self.downsample[0], x))
        return F.relu(out + x)


class PlainResNet(nn.Module):
    def __init__(self, layers: Tuple[int, int, int, int] = (3, 4, 6, 3), width: int = 64,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _kaiming(nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False), generator)
        self.bn1 = FlaxBatchNorm2d(width)
        inplanes = width
        for stage, (mult, blocks) in enumerate(zip((1, 2, 4, 8), layers), 1):
            mods = []
            for b in range(blocks):
                mods.append(PlainBottleneck(inplanes, width * mult,
                                            stride=2 if (b == 0 and stage > 1) else 1,
                                            dtype=dtype, generator=generator))
                inplanes = width * mult * PlainBottleneck.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*mods))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC ``[N, H, W, 3]`` -> pooled features ``[N, width * 32]`` f32."""
        guard = full_f32() if self.dtype == torch.float32 else contextlib.nullcontext()
        with guard:
            x = x.to(self.dtype).permute(0, 3, 1, 2)
            x = F.conv2d(x, self.conv1.weight.to(self.dtype), None, 2, 3)
            x = F.relu(self.bn1(x))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
            for stage in range(1, 5):
                x = getattr(self, f"layer{stage}")(x)
            return x.mean(dim=(2, 3))


def resnet50(dtype=torch.float32, generator: Optional[torch.Generator] = None) -> PlainResNet:
    return PlainResNet(layers=(3, 4, 6, 3), dtype=dtype, generator=generator)
