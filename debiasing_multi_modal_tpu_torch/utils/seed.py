"""Seeding (reference demo/util.py:61-68; the port's counterpart of
``utils/seed.py``).

Returns the two RNG streams the port uses: a numpy Generator for host
sampling decisions (shuffles, balancing, resampling), which draws exactly as
the JAX package's does, and a CPU ``torch.Generator`` for parameter
initialization, which draws the same numbers whatever device the parameters
then move to.  Also seeds the legacy global numpy RNG for any third-party
code.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def set_seed(seed: int) -> Tuple[np.random.Generator, torch.Generator]:
    np.random.seed(seed)
    return np.random.default_rng(seed), torch.Generator().manual_seed(seed)
