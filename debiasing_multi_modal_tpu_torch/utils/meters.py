"""Running meters and step timing (a copy of the JAX package's
``utils/meters.py``).

Parity surface: reference ``demo/util.py`` ``AverageMeter`` (:18-33) and the
per-batch BT/DT accounting printed by the epoch loops (final_main.py:432-488).
The meters track epoch-level wall time (the port's epochs read their
device meters once per epoch); ``StepTimer`` wraps arbitrary phases.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class StepTimer:
    """Named phase timing: ``with timer.phase("train"): ...``; per-phase
    AverageMeters plus a one-line summary."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        if name not in self.meters:
            self.meters[name] = AverageMeter()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.meters[name].update(time.perf_counter() - t0)

    def summary(self) -> str:
        return " ".join(
            f"{name} {m.val:.3f}s ({m.avg:.3f}s)" for name, m in self.meters.items()
        )
