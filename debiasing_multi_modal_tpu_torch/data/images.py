"""Host-side image feed for extraction.

Parity surface: the reference's torchvision Dataset + DataLoader image path
(data/waterbirds.py:60-75, data/celeba.py:58-68 with the transform chain of
clip_inference.py:32-33).  The rebuild splits the transform at the host/device
boundary:

- host (this module): decode + geometric transform only when image sizes vary
  (PIL shorter-side bicubic resize + center crop — identical operations to
  torchvision's), yielding fixed-shape uint8 batches;
- device (ops/preprocess.py): for constant-size sources (CelebA's aligned
  178x218 JPEGs, pre-resized corpora) the host only decodes, and
  resize/crop/normalize run fused on the accelerator.

Batches carry the metadata columns the extraction table needs; the device
step consumes them through ExtractionRunner.run.  (The PyTorch port's copy
of the JAX package's module.)
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from debiasing_multi_modal_tpu_torch.data.groups import GroupTable
from debiasing_multi_modal_tpu_torch.ops.preprocess import resized_dims


def _load_one(path: str, resolution: Optional[int]) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if resolution is not None:
        w, h = img.size
        rh, rw = resized_dims(h, w, resolution)
        if (rh, rw) != (h, w):
            # BILINEAR: the extraction pipeline's effective kernel — the
            # reference's outer torchvision Resize(224) (default BILINEAR)
            # makes CLIP's own bicubic Resize a no-op (clip_inference.py:32)
            img = img.resize((rw, rh), Image.BILINEAR)
        top = int(round((rh - resolution) / 2.0))
        left = int(round((rw - resolution) / 2.0))
        img = img.crop((left, top, left + resolution, top + resolution))
    return np.asarray(img, np.uint8)


def image_batches(
    meta: GroupTable,
    image_root: str,
    batch_size: int,
    host_resolution: Optional[int] = 224,
    path_for: Optional[callable] = None,
    decode_workers: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, Dict[str, np.ndarray]]]:
    """Yield (uint8 [B, H, W, 3], metadata columns) batches in table order.

    ``host_resolution=None`` ships raw decoded images (requires a constant
    source size) and leaves all geometry to the device.

    Decode parallelism (the reference's DataLoader ``num_workers``,
    clip_inference.py:123,198): PIL's JPEG decode and resize release the GIL,
    so a thread pool scales on multi-core hosts.  ``decode_workers``
    defaults to ``os.cpu_count()``; 0/1 decodes inline (on a one-core
    host the pool is pure overhead).
    """
    path_for = path_for or (lambda fn: os.path.join(image_root, fn))
    if decode_workers is None:
        decode_workers = os.cpu_count() or 1
    pool = None
    if decode_workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=decode_workers)
    try:
        n = len(meta)
        for start in range(0, n, batch_size):
            idx = np.arange(start, min(start + batch_size, n))
            paths = [path_for(meta.filenames[i]) for i in idx]
            if pool is not None:
                imgs = np.stack(
                    list(pool.map(lambda p: _load_one(p, host_resolution), paths))
                )
            else:
                imgs = np.stack([_load_one(p, host_resolution) for p in paths])
            yield imgs, {
                "filenames": meta.filenames[idx],
                "y": meta.y[idx],
                "place": meta.place[idx],
                "group": meta.group[idx],
                "split": meta.split[idx],
            }
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
