"""Background host prefetching for the extraction feed.

The reference overlaps decode with GPU compute via DataLoader worker
processes (num_workers=4, clip_inference.py:123).  The port (like the JAX
package, whose module this copies) uses a bounded background-thread
pipeline: a host thread decodes and uploads the next batches while the device
runs the current one (CUDA launches are asynchronous, so a depth-2 buffer
hides host latency when decode is faster than encode); ``num_threads``
producers share one source where one thread cannot decode fast enough.

Cancellation: abandoning the consumer generator (break / exception /
GeneratorExit) sets a stop event; the producers use timed puts, so they observe
it and exit instead of blocking forever on a full queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()
_PUT_POLL_S = 0.1


def prefetch(iterable: Iterable[T], depth: int = 2, num_threads: int = 1) -> Iterator[T]:
    """Iterate ``iterable`` on background thread(s) with a bounded buffer of
    ``depth`` items; ``depth <= 0`` disables prefetching (synchronous
    pass-through).  With ``num_threads > 1`` the threads pull from the
    source under a lock and items come out in completion order (fine for
    extraction, where every batch carries its own metadata)."""
    if depth <= 0:
        return iter(iterable)
    if num_threads < 1:
        # silently yielding an empty stream would look like "no data"
        raise ValueError(f"num_threads must be >= 1, got {num_threads}")
    src = iter(iterable)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    lock = threading.Lock() if num_threads > 1 else None
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
            while not stop.is_set():
                try:
                    if lock is not None:
                        with lock:
                            item = next(src)
                    else:
                        item = next(src)
                except StopIteration:
                    break
                if not _put(item):
                    return
        except BaseException as e:  # surfaced on the consumer side
            errors.append(e)
        finally:
            _put(_SENTINEL)

    def consume():
        # start the producers LAZILY, inside the generator body: if the caller
        # abandons the returned generator before its first next(), no worker
        # was started, so nothing spins on timed puts forever (the finally
        # below only runs once the body has been entered)
        for _ in range(num_threads):
            threading.Thread(target=worker, daemon=True).start()
        finished = 0
        try:
            while finished < num_threads:
                item = q.get()
                if item is _SENTINEL:
                    finished += 1
                    continue
                yield item
            if errors:
                raise errors[0]
        finally:
            stop.set()

    return consume()
