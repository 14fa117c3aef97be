"""A compared number and its limit."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def against(limits: Dict[str, float], readings: Dict[str, float]) -> List[Check]:
    """Each reading beside its limit; a reading without a limit fails."""
    return [Check(k, float(v), float(limits.get(k, -math.inf))) for k, v in readings.items()]


def leaf_gaps(prog: Sequence[float], ref: Sequence[float],
              keep: Sequence[bool] = None) -> List[float]:
    """The gap between two norms of each leaf kept: |prog - ref| against the
    larger of the reference's norm of that leaf and the median leaf's."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    refs = sorted(ref[i] for i in idx)
    median = refs[len(refs) // 2] if refs else 0.0
    return [abs(prog[i] - ref[i]) / max(ref[i], median, 1e-30) for i in idx]


def median_leaf_gap(prog: Sequence[float], ref: Sequence[float],
                    keep: Sequence[bool] = None) -> float:
    gaps = sorted(leaf_gaps(prog, ref, keep))
    return gaps[len(gaps) // 2] if gaps else math.nan
