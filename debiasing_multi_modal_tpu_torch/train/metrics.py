"""Group-accuracy metrics (port of ``train/metrics.py``).

Parity surface: reference ``update_dict`` / ``get_results`` (final_main.py:
383-406) — per-group running correct/count meters, per-group accuracies
``acc_{y}_{p}``, ``mean_acc`` (micro average), ``worst_acc`` (min over the
result dict), and the train-ratio-weighted ``weighted_mean_acc``
(final_main.py:707-714) — plus the fixed print ordering
(``new_order_for_print``, :32-40).

The per-batch Python loop over ``np.unique`` becomes two ``index_add_``
calls on the device (the JAX package's ``segment_sum``); counts in f32 are
exact up to 2^24 rows.  The host turns the epoch's totals into the result
dict once per epoch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from debiasing_multi_modal_tpu_torch.data.groups import group_to_y_p

RESULT_ORDER = (
    "weighted_mean_acc",
    "worst_acc",
    "acc_0_0",
    "acc_0_1",
    "acc_1_0",
    "acc_1_1",
    "mean_acc",
)


def batch_group_counts(
    logits: torch.Tensor,
    labels: torch.Tensor,
    groups: torch.Tensor,
    mask: torch.Tensor,
    n_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(correct_per_group, count_per_group) for one (padded) batch; the
    argmax takes the first maximum, as ``jnp.argmax`` does."""
    correct = (logits.argmax(-1) == labels) & mask
    zeros = torch.zeros(n_groups, dtype=torch.float32, device=logits.device)
    counts = zeros.index_add(0, groups, mask.to(torch.float32))
    corrects = zeros.index_add(0, groups, correct.to(torch.float32))
    return corrects, counts


def results_from_counts(
    corrects: np.ndarray,
    counts: np.ndarray,
    n_places: int = 2,
    train_group_ratio: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Meter totals -> the reference's result dict.

    Groups with zero count report accuracy 0 (an untouched AverageMeter's
    ``avg`` is 0 in the reference) — and therefore drag ``worst_acc`` to 0,
    same as the reference would.
    """
    corrects = np.asarray(corrects, np.float64)
    counts = np.asarray(counts, np.float64)
    accs = np.where(counts > 0, corrects / np.maximum(counts, 1), 0.0)
    results: Dict[str, float] = {}
    for g, acc in enumerate(accs):
        y, p = group_to_y_p(g, n_places)
        results[f"acc_{y}_{p}"] = float(acc)
    results["mean_acc"] = float(corrects.sum() / max(counts.sum(), 1.0))
    results["worst_acc"] = float(min(results.values()))
    if train_group_ratio is not None:
        results["weighted_mean_acc"] = float((accs * np.asarray(train_group_ratio)).sum())
    return results


def ordered(results: Dict[str, float], ndigits: int = 4) -> Dict[str, float]:
    """Reference print ordering + rounding (final_main.py:492-494)."""
    keys = [k for k in RESULT_ORDER if k in results]
    return {k: round(results[k], ndigits) for k in keys}
