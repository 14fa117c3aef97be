"""Prediction CSV artifacts (a copy of the JAX package's
``data/predictions.py``; reference C17:
``data/predictions/waterbirds/prediction.csv`` — image_id -> predicted class
rows used to exchange zero-shot predictions between runs).  The CSV is
byte-identical to the JAX writer's."""

from __future__ import annotations

import csv
import os
from typing import Dict

import numpy as np


def save_predictions(path: str, filenames, preds) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image_id", "prediction"])
        for fn, p in zip(filenames, preds):
            w.writerow([fn, int(p)])


def load_predictions(path: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None or not {
            "image_id", "prediction"
        } <= set(reader.fieldnames):
            # empty/truncated CSV: fail here naming the file, not later as
            # a bare KeyError in predictions_vector
            raise ValueError(
                f"{path}: not a prediction CSV "
                f"(header {reader.fieldnames!r}, need image_id,prediction)"
            )
        for row in reader:
            out[row["image_id"]] = int(row["prediction"])
    return out


def predictions_vector(path: str, filenames) -> np.ndarray:
    """Align a prediction CSV to a filename ordering (e.g. for zero-shot
    group labels à la waterbirds_js.py:57-63)."""
    table = load_predictions(path)
    return np.asarray([table[fn] for fn in filenames], np.int32)
