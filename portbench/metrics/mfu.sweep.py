"""The whole sweep's share of the card's float32 peak, in percent: forward
and backward FLOPs per trained sample counted from the adapter's shapes
(``counts/flops.adapter_train_flops``: D->H->D, the frozen first adapter's
forward in phase 2, the zero-shot head) summed over every epoch of the
traced run's window, over the window's time and 67 TFLOP/s (the port trains
in float32 with TF32 off)."""

from portbench.counts.peaks import PEAK_FLOPS


def read(record):
    flops, window = record.notes.get("train_flops"), record.notes.get("window_s")
    if not flops or not window:
        return None
    return 100.0 * flops / window / PEAK_FLOPS["float32"]
