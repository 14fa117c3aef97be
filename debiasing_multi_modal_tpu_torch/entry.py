"""The flagship step as one callable (the counterpart of
``__graft_entry__.py::entry``).

:func:`entry` returns ``(fn, args)``: ``fn(*args)`` is the RN50 extraction
step of the main path (preprocess the uint8 batch, ``encode_image``, the
zero-shot argmax against a text matrix) on seeded weights and a seeded batch
of eight 224x224 images, on the card unless the CPU is asked for (bf16 on
the card, f32 on the CPU, as the JAX entry picks its dtype by backend,
unless ``dtype`` is given).
The class weights stay un-normalized and only the image side is
normalized, as the extraction runner does; the logits' product runs at full
f32 (``utils/platform.full_f32``).

    python -m debiasing_multi_modal_tpu_torch.entry
"""

from __future__ import annotations

import numpy as np
import torch

from debiasing_multi_modal_tpu_torch.utils.platform import DeviceLike, full_f32, resolve_device


def entry(device: DeviceLike = None, dtype=None):
    from debiasing_multi_modal_tpu_torch.models import create_clip
    from debiasing_multi_modal_tpu_torch.models.clip import l2_normalize
    from debiasing_multi_modal_tpu_torch.ops.preprocess import preprocess_uint8

    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = create_clip("RN50", dtype=dtype, device=dev,
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    text = torch.from_numpy(
        rng.standard_normal((model.config.embed_dim, 2)).astype(np.float32)).to(dev)

    @torch.no_grad()
    def forward(model, images, text):
        x = preprocess_uint8(images, model.config.image_resolution, dtype=dtype)
        feats = model.encode_image(x)
        with full_f32():
            logits = l2_normalize(feats.float()) @ text / 0.02
        return feats, torch.argmax(logits, dim=-1)

    images = torch.from_numpy((rng.random((8, 224, 224, 3)) * 255).astype(np.uint8)).to(dev)
    return forward, (model, images, text)


if __name__ == "__main__":
    fn, args = entry()
    feats, preds = fn(*args)
    print("entry ran:", tuple(feats.shape), preds.tolist())
