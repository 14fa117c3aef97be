"""Training augmentations on the device (port of ``ops/augment.py``).

Parity surface: reference ``get_transform_cub(train=True)``
(data/waterbirds.py:78-98) — RandomResizedCrop(224, scale=(0.7, 1.0)) +
RandomHorizontalFlip — and ``TwoCropTransform`` (demo/util.py:9-15) used by
the SupCon workspace.

A crop is bilinear sampling at per-image boxes, batched: one gather of the
four neighbours of every output pixel, as the JAX module's ``vmap`` does.
The draws come from an explicit ``torch.Generator``.  JAX's PRNG bits cannot
be reproduced, so the draw and the sampling are split: :func:`crop_boxes`
and :func:`flip_draws` draw, :func:`resized_crop` and
:func:`horizontal_flip` are deterministic, and the random functions compose
them.  Given the same boxes, :func:`resized_crop` is the JAX crop's
arithmetic (source coordinates clamped to the image before the weights, as
JAX ``augment.py:27-30`` and PIL do).  ``lo + grid * size`` is rounded to
f32 once, from f64, as XLA's fused multiply-add rounds it (two f32 steps
would round twice): one f32 ulp of a coordinate near 256 moves a bilinear
weight by 3e-5, i.e. a uint8 pixel by up to 8e-3.  So the card and the CPU
compute the same coordinates.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _uniform(generator: torch.Generator, n: int, lo: float, hi: float,
             device: torch.device) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=generator.device, dtype=torch.float32)
    return (u * (hi - lo) + lo).to(device)


def crop_boxes(generator: torch.Generator, n: int, h: int, w: int,
               scale_range: Tuple[float, float] = (0.7, 1.0),
               ratio_range: Tuple[float, float] = (3 / 4, 4 / 3),
               device: Optional[torch.device] = None):
    """torchvision RandomResizedCrop's box draw, vectorized: area scale and
    log-aspect uniform, the box clipped to the image, its corner uniform
    in the rest.  Returns ``(y0, x0, ch, cw)``, each ``[n]`` f32."""
    device = generator.device if device is None else device
    area = _uniform(generator, n, scale_range[0], scale_range[1], device) * (h * w)
    log_r = _uniform(generator, n, math.log(ratio_range[0]), math.log(ratio_range[1]), device)
    ratio = torch.exp(log_r)
    cw = torch.clamp(torch.sqrt(area * ratio), 1.0, float(w))
    ch = torch.clamp(torch.sqrt(area / ratio), 1.0, float(h))
    y0 = _uniform(generator, n, 0.0, 1.0, device) * (h - ch)
    x0 = _uniform(generator, n, 0.0, 1.0, device) * (w - cw)
    return y0, x0, ch, cw


def resized_crop(images: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                 ch: torch.Tensor, cw: torch.Tensor, out_res: int = 224) -> torch.Tensor:
    """Each image's box ``(y0, x0, ch, cw)`` bilinearly resampled to
    ``out_res x out_res``: ``images [N, H, W, C]`` (any real dtype) ->
    ``[N, out_res, out_res, C]`` f32."""
    n, h, w, _ = images.shape
    # (k + 0.5) / R in f32, correctly rounded: from f64, because the card
    # divides by a scalar as a product with its reciprocal
    grid = ((torch.arange(out_res, device=images.device, dtype=torch.float64) + 0.5)
            / out_res).float()

    def coords(lo, size):  # [N, R]: lo + grid * size, rounded once to f32
        exact = lo.double()[:, None] + grid.double()[None, :] * size.double()[:, None]
        return exact.float() - 0.5

    ys, xs = coords(y0, ch), coords(x0, cw)
    ys = ys.clamp(0.0, h - 1.0)
    xs = xs.clamp(0.0, w - 1.0)
    iy0 = torch.floor(ys).long().clamp(0, h - 1)
    ix0 = torch.floor(xs).long().clamp(0, w - 1)
    iy1 = (iy0 + 1).clamp(0, h - 1)
    ix1 = (ix0 + 1).clamp(0, w - 1)
    wy = (ys - iy0.float())[:, :, None, None]  # [N, R, 1, 1]
    wx = (xs - ix0.float())[:, None, :, None]  # [N, 1, R, 1]
    rows = torch.arange(n, device=images.device)[:, None, None]

    def at(iy, ix):
        return images[rows, iy[:, :, None], ix[:, None, :]].float()  # [N, R, R, C]

    top = at(iy0, ix0) * (1 - wx) + at(iy0, ix1) * wx
    bot = at(iy1, ix0) * (1 - wx) + at(iy1, ix1) * wx
    return top * (1 - wy) + bot * wy


def random_resized_crop(generator: torch.Generator, images: torch.Tensor, out_res: int = 224,
                        scale_range: Tuple[float, float] = (0.7, 1.0),
                        ratio_range: Tuple[float, float] = (3 / 4, 4 / 3)) -> torch.Tensor:
    """torchvision RandomResizedCrop semantics (area-scale + aspect draw,
    bilinear resize), batched."""
    n, h, w, _ = images.shape
    boxes = crop_boxes(generator, n, h, w, scale_range, ratio_range, images.device)
    return resized_crop(images, *boxes, out_res=out_res)


def flip_draws(generator: torch.Generator, n: int,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """``[n]`` bool, each True with probability 1/2."""
    device = generator.device if device is None else device
    return (torch.rand(n, generator=generator, device=generator.device) < 0.5).to(device)


def horizontal_flip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """``images [N, H, W, C]`` with the rows of the images where ``flip``
    holds reversed left to right."""
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def random_horizontal_flip(generator: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    return horizontal_flip(images, flip_draws(generator, images.shape[0], images.device))


def train_augment(generator: torch.Generator, images: torch.Tensor, out_res: int = 224,
                  scale_range: Tuple[float, float] = (0.7, 1.0)) -> torch.Tensor:
    """RandomResizedCrop + RandomHorizontalFlip (get_transform_cub train)."""
    out = random_resized_crop(generator, images, out_res, scale_range)
    return random_horizontal_flip(generator, out)


def two_crop(generator: torch.Generator, images: torch.Tensor, out_res: int = 224):
    """Two independent augmented views per image (TwoCropTransform)."""
    return (train_augment(generator, images, out_res),
            train_augment(generator, images, out_res))
