"""What a loop is given and what it returns."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional

from portbench.checks.common import Check
from portbench.core.record import Record


@dataclass
class Context:
    workload: str
    seed: int
    seconds: float
    config: dict
    traffic: dict
    limits: Dict[str, float]
    device: object  # torch.device
    t_start: float  # perf_counter at process start: set-up is measured from it
    record: Optional[Record] = None  # present in a traced run
    # faults planted under the timed path (tests of the comparison only)
    faults: FrozenSet[str] = frozenset()


@dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]
    memory_peak_bytes: int
    notes: Dict[str, object] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(c.ok for c in self.checks)
