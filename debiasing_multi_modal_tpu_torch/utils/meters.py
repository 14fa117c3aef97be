"""Running meters (a copy of the JAX package's ``utils/meters.py``
``AverageMeter``).

Parity surface: reference ``demo/util.py`` ``AverageMeter`` (:18-33) and the
per-batch BT/DT accounting printed by the epoch loops (final_main.py:432-488).
The meters track epoch-level wall time (the port's epochs read their
device meters once per epoch).  Phase timing is ``utils/profiling.annotate``.
"""

from __future__ import annotations


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
