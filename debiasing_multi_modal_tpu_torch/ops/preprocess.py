"""On-device image preprocessing: resize + center crop + normalize (port of
``ops/preprocess.py``).

The reference chain (clip_inference.py:32-33 + clip/clip.py:79-86) nets out
to a shorter-side BILINEAR resize (antialiased, long side truncated), a
center crop and CLIP normalization; ``method="bicubic"`` gives the standalone
``clip.load`` preprocessing.

The resize is two matmuls against separable resampling matrices (the
antialiased triangle or Keys kernel), with the crop folded into the matrices
as a row slice, so cropped-away rows are never computed.  The matmuls run in
f32 at full precision (no TF32), as ``Precision.HIGHEST`` does in the JAX
package.  The host only decodes; the whole transform runs on the tensor's
device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

# CLIP normalization constants (clip/clip.py:85)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resized_dims(h: int, w: int, target: int) -> Tuple[int, int]:
    """torchvision Resize(shorter-side) output size; the long side is
    TRUNCATED (``int(size * long / short)``)."""
    if h <= w:
        return target, max(target, int(w * target / h))
    return max(target, int(h * target / w)), target


def _cubic_kernel(t: np.ndarray) -> np.ndarray:
    """Keys cubic (a = -0.5) — the kernel behind bicubic resampling."""
    t = np.abs(t)
    return np.where(
        t <= 1.0,
        1.5 * t ** 3 - 2.5 * t ** 2 + 1.0,
        np.where(t < 2.0, -0.5 * t ** 3 + 2.5 * t ** 2 - 4.0 * t + 2.0, 0.0),
    )


def _linear_kernel(t: np.ndarray) -> np.ndarray:
    """Triangle kernel — bilinear resampling."""
    return np.maximum(0.0, 1.0 - np.abs(t))


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int, antialias: bool = True,
                  method: str = "bilinear") -> np.ndarray:
    """[out_size, in_size] separable resampling matrix (half-pixel sampling,
    antialiased support scaling when downsampling, edge clamping by weight
    renormalization — ``jax.image.resize`` semantics)."""
    kernel = {"bilinear": _linear_kernel, "bicubic": _cubic_kernel}[method]
    scale = out_size / in_size
    kscale = max(1.0, 1.0 / scale) if antialias else 1.0
    x = (np.arange(out_size) + 0.5) / scale - 0.5
    j = np.arange(in_size)
    t = (x[:, None] - j[None, :]) / kscale
    weights = kernel(t) / kscale
    weights = weights / weights.sum(axis=1, keepdims=True)
    weights = weights.astype(np.float32)
    weights.flags.writeable = False  # cached and shared between callers
    return weights


def _normalize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def preprocess_uint8(images: torch.Tensor, resolution: int = 224,
                     antialias: bool = True, dtype=torch.float32,
                     method: str = "bilinear") -> torch.Tensor:
    """uint8 ``[N, H, W, 3]`` -> CLIP-normalized ``[N, resolution, resolution, 3]``."""
    n, h, w, c = images.shape
    x = images.float() / 255.0
    rh, rw = resized_dims(h, w, resolution)
    top = int(round((rh - resolution) / 2.0))
    left = int(round((rw - resolution) / 2.0))

    if (rh, rw) != (h, w):
        x = x.permute(0, 3, 1, 2)  # [n, c, h, w]: spatial axes minor for the matmuls
        if rh != h:
            mh = torch.from_numpy(
                resize_matrix(h, rh, antialias, method)[top:top + resolution].copy()
            ).to(x.device)
            x = torch.einsum("oh,nchw->ncow", mh, x)
            if dtype == torch.bfloat16 and rw != w:
                # the JAX package stores the intermediate between the two
                # resizes in bf16 (pixels are [0,1]-scale, rounding <= 0.002)
                x = x.to(torch.bfloat16).float()
        else:
            x = x[:, :, top:top + resolution]
        if rw != w:
            mw = torch.from_numpy(
                resize_matrix(w, rw, antialias, method)[left:left + resolution].copy()
            ).to(x.device)
            x = torch.einsum("pw,ncow->ncop", mw, x)
        else:
            x = x[:, :, :, left:left + resolution]
        x = x.clamp(0.0, 1.0)  # PIL clamps resampled values into range
        x = x.permute(0, 2, 3, 1)  # back to NHWC
    else:
        x = x[:, top:top + resolution, left:left + resolution]
    return _normalize(x, dtype)


def normalize_only(images_01: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Normalize an already-resized [0,1] float batch (bench/synthetic path)."""
    return _normalize(images_01.float(), dtype)
