"""Identity-keyed host -> device staging cache (the port's counterpart of
``utils/staging.py``).

The training loop passes the same numpy arrays (labels, groups, text
matrices) into the epoch functions every epoch.  ``DeviceCache`` stages each
distinct host array on the device once and returns the resident tensor on
every later call.  Uploads go through :func:`upload` (pinned memory, a
non-blocking copy), so staging never makes the host wait for the card.

The cache holds a reference to the host array, so an ``id()`` can never be
recycled while its entry is alive.  Tensors already on the cache's device
pass through untouched.

NO EVICTION: every staged host array (and its device tensor) stays pinned
for the cache's lifetime.  Do NOT stage per-call fresh arrays (e.g.
``stage(a[order])`` inside an epoch loop): each call would pin a new entry
forever.  Call ``clear()`` to drop everything.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from debiasing_multi_modal_tpu_torch.utils.platform import (
    DeviceLike,
    on_device,
    resolve_device,
)


def upload(array, device: torch.device) -> torch.Tensor:
    """A numpy array (or CPU tensor) as a tensor on ``device``.  On the card
    the copy is non-blocking from pinned memory: the host never waits for it
    (a pageable copy would), and the caching host allocator keeps the pinned
    buffer alive until the copy has run."""
    t = torch.as_tensor(np.ascontiguousarray(array)) if isinstance(array, np.ndarray) \
        else torch.as_tensor(array)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class DeviceCache:
    """Callable: ``cache(host_array) -> device tensor`` (staged at most once)."""

    def __init__(self, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self._cache: Dict[int, Tuple[Any, torch.Tensor]] = {}

    def __call__(self, arr) -> torch.Tensor:
        if isinstance(arr, torch.Tensor) and on_device(arr, self.device):
            return arr
        got = self._cache.get(id(arr))
        if got is None or got[0] is not arr:
            got = (arr, upload(arr, self.device))
            self._cache[id(arr)] = got
        return got[1]

    def __len__(self) -> int:
        return len(self._cache)

    def clear(self) -> None:
        """Release every pinned host reference and device tensor."""
        self._cache.clear()
