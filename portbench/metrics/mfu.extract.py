"""The whole step's share of the card's bf16 peak, in percent: forward FLOPs
per image counted from the configuration's shapes (``counts/flops.py``:
convolutions, attention pool or ViT blocks, patch embedding, zero-shot head)
times the images per second of the traced run's window, over 989 TFLOP/s
(the card's power limit is in the result's ``device``)."""

from portbench.counts.peaks import PEAK_FLOPS


def read(record):
    rate, flops = record.notes.get("imgs_per_s"), record.notes.get("image_flops")
    if not rate or not flops:
        return None
    return 100.0 * flops * rate / PEAK_FLOPS["bfloat16"]
