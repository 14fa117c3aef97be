"""Deterministic sampling machinery: stratified reg/val split, per-epoch
group-balanced subsets, zero-shot-failure resampling weights, and padded
batch plans (the port's numpy copy of ``data/samplers.py``).

Every function draws from the numpy ``Generator`` in the JAX package's
order, so one ``random_seed`` gives both packages the same batch plans.

Parity surfaces:

- ``stratified_split_indices`` — reference ``stratified_split_dataset``
  (data/waterbirds_embeddings_reg.py:97-109): sklearn ``train_test_split``
  with ``random_state=42`` stratified on the group label, splitting the val
  set into a regularization half and an eval half.
- ``balanced_subset_indices`` — reference ``balance_val`` (final_main.py:
  346-379): per-epoch within-group shuffle, truncate every group to the
  minimum group size, then interleave groups round-robin
  (``zip(*g_idx)`` -> reshape).
- ``resampled_ce_weights`` — reference ``GetResampledWeightsCE`` +
  ``GetNegativesByClass`` (demo/visualizer_supcon.py:1617-1703): up-weight
  zero-shot-incorrect samples so correct:incorrect balances per class, with
  optional class-distribution bias correction; consumed by a
  with-replacement weighted sampler (final_main.py:868-884).
- ``BatchPlan`` — replaces the torch DataLoader: a full epoch of batch
  indices as one [num_batches, batch_size] int array plus a validity mask
  (drop_last=False semantics with fixed shapes — the epoch step masks
  padded rows; see train/steps.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def stratified_split_indices(
    group_array: np.ndarray, test_size: float = 0.5, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """(reg_indices, val_indices) stratified on group, sklearn-seeded.

    Uses sklearn when available for bit-compatibility with the reference's
    split (same random_state), else a numpy fallback with identical
    proportions.
    """
    n = len(group_array)
    try:
        from sklearn.model_selection import train_test_split

        reg_idx, val_idx = train_test_split(
            np.arange(n),
            test_size=test_size,
            random_state=seed,
            stratify=group_array,
        )
        return np.asarray(reg_idx), np.asarray(val_idx)
    except ImportError:  # pragma: no cover
        rng = np.random.default_rng(seed)
        reg_parts, val_parts = [], []
        for g in np.unique(group_array):
            idx = np.where(group_array == g)[0]
            rng.shuffle(idx)
            cut = int(round(len(idx) * (1 - test_size)))
            reg_parts.append(idx[:cut])
            val_parts.append(idx[cut:])
        return np.concatenate(reg_parts), np.concatenate(val_parts)


def balanced_subset_indices(
    group_array: np.ndarray, rng: np.random.Generator, n_groups: Optional[int] = None
) -> np.ndarray:
    """Per-epoch group-balanced downsample, round-robin interleaved."""
    n_groups = n_groups or int(group_array.max()) + 1
    g_idx = [np.where(group_array == g)[0] for g in range(n_groups)]
    min_g = min(len(g) for g in g_idx)
    picked = []
    for g in g_idx:
        g = g.copy()
        rng.shuffle(g)
        picked.append(g[:min_g])
    # [g0_0, g1_0, ..., gK_0, g0_1, ...] — same interleave as zip(*g_idx)
    return np.stack(picked, axis=1).reshape(-1)


def resampled_ce_weights(
    labels: np.ndarray,
    zs_preds: np.ndarray,
    n_classes: int = 2,
    correct_class_bias: bool = True,
    reweighting_by_class: bool = False,
) -> np.ndarray:
    """Sampling weights that re-balance zero-shot-correct vs -incorrect
    samples per class (the ``--resample_ce`` path)."""
    labels = np.asarray(labels)
    correct = zs_preds == labels
    weights = np.ones(len(labels), np.float64)

    n_pos = np.zeros(n_classes, np.int64)  # zero-shot correct per class
    n_cls = np.zeros(n_classes, np.int64)
    for c in range(n_classes):
        cls_mask = labels == c
        pos = cls_mask & correct
        neg = cls_mask & ~correct
        n_pos[c] = pos.sum()
        n_cls[c] = cls_mask.sum()
        if n_pos[c] >= neg.sum() and neg.sum() > 0:
            weights[neg] = n_pos[c] / neg.sum()

    if (correct_class_bias or reweighting_by_class) and n_classes == 2:
        if n_cls[0] < n_cls[1]:
            minor_c = 0
            imbal = n_cls[1] / max(n_cls[0], 1)
            reweighted = n_pos[1] / max(n_pos[0], 1)
        else:
            minor_c = 1
            imbal = n_cls[0] / max(n_cls[1], 1)
            reweighted = n_pos[0] / max(n_pos[1], 1)
        minor_mask = labels == minor_c
        if imbal < reweighted:
            factor = (reweighted / imbal) if not reweighting_by_class else reweighted
            weights[minor_mask] *= factor
        elif reweighting_by_class:
            weights[minor_mask] *= reweighted
    return weights


def weighted_sample_indices(
    weights: np.ndarray, num_samples: int, rng: np.random.Generator
) -> np.ndarray:
    """With-replacement weighted sampling (torch WeightedRandomSampler)."""
    p = np.asarray(weights, np.float64)
    p = p / p.sum()
    return rng.choice(len(weights), size=num_samples, replace=True, p=p)


# ----------------------------------------------------------------- batching --


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """A full epoch of gather indices with padding masks (static shapes)."""

    indices: np.ndarray  # [num_batches, batch_size] int32 into the dataset
    mask: np.ndarray  # [num_batches, batch_size] bool — False on padded slots

    @property
    def num_batches(self) -> int:
        return self.indices.shape[0]

    @property
    def batch_size(self) -> int:
        return self.indices.shape[1]

    @property
    def num_examples(self) -> int:
        return int(self.mask.sum())


def make_batch_plan(
    order: np.ndarray, batch_size: int, drop_last: bool = False
) -> BatchPlan:
    """Split an example ordering into fixed-shape batches.

    The final partial batch is kept (reference DataLoader drop_last=False)
    and padded with index 0 under a False mask.
    """
    n = len(order)
    if drop_last:
        nb = n // batch_size
        order = order[: nb * batch_size]
        idx = order.reshape(nb, batch_size).astype(np.int32)
        return BatchPlan(idx, np.ones_like(idx, bool))
    nb = -(-n // batch_size) if n else 0
    padded = np.zeros(nb * batch_size, np.int32)
    padded[:n] = order
    mask = np.zeros(nb * batch_size, bool)
    mask[:n] = True
    return BatchPlan(
        padded.reshape(nb, batch_size), mask.reshape(nb, batch_size)
    )


def epoch_plan(
    n: int,
    batch_size: int,
    shuffle: bool,
    rng: Optional[np.random.Generator] = None,
    order: Optional[np.ndarray] = None,
) -> BatchPlan:
    """Standard loader semantics: (shuffled) arange -> fixed-shape batches."""
    if order is None:
        order = np.arange(n, dtype=np.int64)
        if shuffle:
            assert rng is not None, "shuffle requires an rng"
            order = rng.permutation(n)
    return make_batch_plan(np.asarray(order), batch_size)


def cached_eval_plan(cache, split, batch_size, put):
    """Identity-guarded eval-plan cache: ``(split, batch_size)`` -> staged
    ``(indices, mask)`` device tensors built by ``put``.

    Eval plans would be rebuilt and uploaded every epoch without this; the
    cache keys on ``id(split)`` but RETAINS the split object in the entry
    and verifies identity on hit, so a recycled id() after garbage
    collection can never alias to a wrong-length plan (the same guard
    utils/staging.DeviceCache applies to host arrays).  ``cache=None``
    disables caching (plans are rebuilt per call)."""
    key = (id(split), batch_size)
    entry = None if cache is None else cache.get(key)
    if entry is not None and entry[0] is split:
        return entry[1]
    plan = epoch_plan(len(split), batch_size, shuffle=False)
    staged = (put(plan.indices), put(plan.mask))
    if cache is not None:
        cache[key] = (split, staged)
    return staged
