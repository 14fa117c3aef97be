#!/usr/bin/env python
"""Write a seeded random CLIP ResNet checkpoint with the PyTorch port.

    python scripts/make_synthetic_checkpoint_torch.py ROOT [--geometry narrow|RN50]

Writes ``ROOT/RN50.pt``, the checkpoint of the synthetic fixture that
``scripts/reproduce_all_torch.sh`` reads (the images and metadata come from
``scripts/make_synthetic_fixture.py ROOT --skip_checkpoint``).  The model is
the port's CLIP drawn from seed :data:`SEED` with the reference's own init scheme
(``create_clip(..., scratch_init="reference")``); its ``state_dict()`` is in
OpenAI's key layout and goes into a TorchScript archive as OpenAI ships
theirs (``weights/convert.py::save_jit_state_dict_archive``), so any
extraction CLI sniffs the geometry from the tensors.

- ``narrow`` (default): ``make_synthetic_fixture.py``'s geometry at its
  default width, a ResNet of vision width :data:`NARROW_WIDTH` with one
  block a stage, embed ``32 * NARROW_WIDTH``,
  224 pixels, and a one-layer, 64-wide text tower with the full 49,408-token
  vocabulary: fast on the CPU.
- ``RN50``: RN50's published widths (embed 1024, blocks (3, 4, 6, 3), width
  64, text 512 wide, 8 heads, 12 layers).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 0
NARROW_WIDTH = 8


def geometry(name: str):
    from debiasing_multi_modal_tpu_torch.models.config import CLIPConfig, get_config

    if name == "RN50":
        return get_config("RN50")
    # the reference CLIP(width * 32, 224, (1, 1, 1, 1), width, None, 77, 49408, 64, 1, 1)
    return CLIPConfig(name="RN50", embed_dim=NARROW_WIDTH * 32, image_resolution=224,
                      vision_layers=(1, 1, 1, 1), vision_width=NARROW_WIDTH,
                      vision_patch_size=None,
                      context_length=77, vocab_size=49408, transformer_width=64,
                      transformer_heads=1, transformer_layers=1)


def make_checkpoint(path: str, name: str = "narrow") -> None:
    import torch

    from debiasing_multi_modal_tpu_torch.models import create_clip
    from debiasing_multi_modal_tpu_torch.weights.convert import save_jit_state_dict_archive

    model = create_clip(geometry(name), dtype=torch.float32, device="cpu",
                        generator=torch.Generator().manual_seed(SEED),
                        scratch_init="reference")
    save_jit_state_dict_archive(model.state_dict(), path)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--geometry", default="narrow", choices=["narrow", "RN50"])
    args = ap.parse_args()
    os.makedirs(args.root, exist_ok=True)
    path = os.path.join(args.root, "RN50.pt")
    make_checkpoint(path, args.geometry)
    print(f"wrote {path} ({args.geometry})")


if __name__ == "__main__":
    main()
