"""Contrastive-adapter data machinery: prediction slices, anchor/positive/
negative pools, and contrastive batch construction (the port's numpy copy of
``data/contrastive.py``: one ``np.random.Generator`` gives both packages the
same rows, bit for bit).

Parity surface: reference ``demo/visualizer_supcon.py`` —

- ``compute_slice_indices`` (:1100-1145): slices = groups of samples sharing a
  zero-shot *prediction*, with per-slice correctness masks.
- ``prepare_contrastive_points`` (:1148-1339): per slice, anchors are the
  ZS-incorrect samples; negatives are the ZS-correct samples of that slice
  (different class, same prediction) PLUS the "easy negatives" appended from
  the other slice's anchors (:1280-1312); positives are collected by class
  from the correct samples.
- ``construct_contrastive_data`` (:1342-1435): per anchor, one row of
  ``[anchor, extra anchors, positives, negatives]`` indices sampled with
  replacement when a pool is short.
- ``load_contrastive_loader`` (:1437-1484): optional class balancing by
  zipping the per-slice row lists (down-sampling the slice with more
  failures) and shuffling.

All of it is pure numpy over the columnar tables (no DataLoader, no pandas);
the training side uploads the row-index matrix once per epoch and gathers
from the resident embeddings on the device (train/contrastive).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class ContrastivePoints:
    """Per-slice anchor/negative pools and per-class positive pools."""

    slice_anchors: List[Dict[str, np.ndarray]]  # per slice: ix, target, ix_by_class
    slice_negatives: List[Dict[str, np.ndarray]]  # per slice: ix (incl. easy negs)
    positives_by_class: Dict[int, Dict[str, np.ndarray]]


def compute_slices(labels: np.ndarray, zs_preds: np.ndarray):
    """(sliced_data_indices, sliced_data_correct) keyed by prediction value."""
    slices, correct = [], []
    for pred in np.unique(zs_preds):
        idx = np.where(zs_preds == pred)[0]
        slices.append(idx)
        correct.append(zs_preds[idx] == labels[idx])
    return slices, correct


def prepare_contrastive_points(
    labels: np.ndarray,
    zs_preds: np.ndarray,
) -> ContrastivePoints:
    slices, correct = compute_slices(labels, zs_preds)
    n_slices = len(slices)

    slice_anchors: List[Dict[str, np.ndarray]] = [None] * n_slices
    slice_negatives: List[Dict[str, np.ndarray]] = [None] * n_slices
    positives_by_class: Dict[int, Dict[str, np.ndarray]] = {}

    for s, idx in enumerate(slices):
        incorrect = ~correct[s]
        anchors = idx[incorrect]
        anchor_targets = labels[anchors]
        ix_by_class = {
            int(c): anchors[anchor_targets == c] for c in np.unique(anchor_targets)
        }
        slice_anchors[s] = {
            "ix": anchors,
            "target": anchor_targets,
            "ix_by_class": ix_by_class,
        }
        negatives = idx[correct[s]]  # same prediction, different class than anchors
        slice_negatives[s] = {"ix": negatives, "target": labels[negatives]}

        # correct samples feed the positive pool of their class
        for c in np.unique(labels[negatives]):
            pix = negatives[labels[negatives] == c]
            if int(c) in positives_by_class:
                positives_by_class[int(c)]["ix"] = np.concatenate(
                    [positives_by_class[int(c)]["ix"], pix]
                )
            else:
                positives_by_class[int(c)] = {"ix": pix}

    # easy negatives: each slice's anchors are appended to the *other*
    # slice's negative pool (visualizer_supcon.py:1280-1312, binary case)
    if n_slices == 2:
        for s in range(2):
            other = 1 - s
            slice_negatives[other]["ix"] = np.concatenate(
                [slice_negatives[other]["ix"], slice_anchors[s]["ix"]]
            )
            slice_negatives[other]["target"] = labels[slice_negatives[other]["ix"]]

    return ContrastivePoints(slice_anchors, slice_negatives, positives_by_class)


def clamp_counts(
    points: ContrastivePoints,
    num_anchor: int,
    num_positive: int,
    num_negative: int,
):
    """Clamp requested row counts to the smallest available pools.

    Reference parity: the working notebook flow calls ``adjust_num_pos_neg_``
    before building rows (SupCon.ipynb cell 6:41-66, invoked cell 10:58) —
    ``num_positive``/``num_negative`` shrink to the smallest class-positive /
    slice-negative pool, and ``num_anchor`` to their minimum — rather than
    sampling with replacement, which would inflate the SupCon denominator
    with duplicates.  Empty pools are excluded from the minima (their anchors
    are skipped in construct_contrastive_rows; the reference crashes on
    them).  Returns the clamped ``(num_anchor, num_positive, num_negative)``.
    """
    pos_sizes = [
        len(d["ix"]) for d in points.positives_by_class.values() if len(d["ix"])
    ]
    neg_sizes = [len(d["ix"]) for d in points.slice_negatives if len(d["ix"])]
    if pos_sizes:
        num_positive = min(num_positive, min(pos_sizes))
    if neg_sizes:
        num_negative = min(num_negative, min(neg_sizes))
    num_anchor = min(num_anchor, num_positive, num_negative)
    return max(num_anchor, 1), num_positive, num_negative


def _sample(pool: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    if len(pool) == 0:
        raise ValueError("empty contrastive pool")
    return rng.choice(pool, size=k, replace=k > len(pool))


def construct_contrastive_rows(
    points: ContrastivePoints,
    num_anchor: int,
    num_positive: int,
    num_negative: int,
    rng: np.random.Generator,
    balance_by_zs_pred: bool = True,
    shuffle: bool = True,
) -> np.ndarray:
    """[R, num_anchor + num_positive + num_negative] index rows."""
    per_slice: List[List[np.ndarray]] = []
    skipped = 0
    for s, anchor_dict in enumerate(points.slice_anchors):
        rows = []
        neg_pool = points.slice_negatives[s]["ix"]
        for aix, anchor in enumerate(anchor_dict["ix"]):
            c = int(anchor_dict["target"][aix])
            if (
                c not in points.positives_by_class
                or len(points.positives_by_class[c]["ix"]) == 0
                or len(neg_pool) == 0
            ):
                # degenerate zero-shot predictions: a class with no correct
                # samples has no positive pool (the reference crashes here,
                # visualizer_supcon.py sample_positives); skip its anchors
                skipped += 1
                continue
            extra = _sample(anchor_dict["ix_by_class"][c], num_anchor - 1, rng) \
                if num_anchor > 1 else np.empty(0, np.int64)
            pos = _sample(points.positives_by_class[c]["ix"], num_positive, rng)
            neg = _sample(neg_pool, num_negative, rng)
            rows.append(np.concatenate([[anchor], extra, pos, neg]))
        if shuffle:
            rng.shuffle(rows)
        per_slice.append(rows)
    if skipped:
        import warnings

        warnings.warn(
            f"contrastive rows: skipped {skipped} anchors whose class has no "
            "zero-shot-correct positives (degenerate predictions)"
        )
    if not any(per_slice):
        n_anchors = sum(len(a["ix"]) for a in points.slice_anchors)
        detail = (
            "the zero-shot predictions are all correct, so there are no "
            "anchors (contrastive_adapter trains on ZS mistakes)"
            if n_anchors == 0
            else "no anchor class has zero-shot-correct positive samples"
        )
        raise ValueError(f"no contrastive rows could be built: {detail}")

    if balance_by_zs_pred and len(per_slice) == 2 and all(per_slice):
        # down-sample the slice with more failures by interleaved zip
        paired = list(zip(*per_slice))
        rows = [r for pair in paired for r in pair]
    else:
        rows = [r for sl in per_slice for r in sl]
    if shuffle:
        rng.shuffle(rows)
    return np.asarray(rows, np.int64)
