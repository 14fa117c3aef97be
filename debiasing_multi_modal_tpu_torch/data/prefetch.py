"""Background host prefetching for the extraction feed.

The reference overlaps decode with GPU compute via DataLoader worker
processes (num_workers=4, clip_inference.py:123).  The port (like the JAX
package, whose module this copies) uses a bounded background-thread
pipeline: a host thread decodes and uploads the next batches while the device
runs the current one (CUDA launches are asynchronous, so a depth-2 buffer
hides host latency when decode is faster than encode).

Cancellation: abandoning the consumer generator (break / exception /
GeneratorExit) sets a stop event; the producer uses timed puts, so it observes it
and exits instead of blocking forever on a full queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()
_PUT_POLL_S = 0.1


def prefetch(iterable: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``iterable`` on a background thread with a bounded buffer of
    ``depth`` items; ``depth <= 0`` disables prefetching (synchronous
    pass-through)."""
    if depth <= 0:
        return iter(iterable)
    src = iter(iterable)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    errors = []

    def _put(item) -> bool:
        """Timed put so a blocked producer observes cancellation."""
        while not stop.is_set():
            try:
                q.put(item, timeout=_PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in src:
                if stop.is_set() or not _put(item):
                    return
        except BaseException as e:  # surfaced on the consumer side
            errors.append(e)
        finally:
            _put(_SENTINEL)

    def consume():
        # start the producer LAZILY, inside the generator body: if the caller
        # abandons the returned generator before its first next(), no worker
        # was started, so nothing spins on timed puts forever (the finally
        # below only runs once the body has been entered)
        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                yield item
            if errors:
                raise errors[0]
        finally:
            stop.set()

    return consume()
