"""Benchmark-side spans and counters around the program's calls.

Nothing here edits the program: a span wraps a bound method of one instance
(the instance attribute shadows the class's method) or a function in a
module's namespace for the duration of a ``with`` block, and device spans
come from CUDA events recorded by forward hooks.  A :class:`Record` keeps
everything in memory; the metric readers take their numbers from it once the
run is over.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple


class Record:
    """Host spans (perf_counter seconds), device spans (CUDA event pairs,
    read once after the window), counters and anything a loop notes."""

    def __init__(self, workload: str, config: dict, traffic: dict):
        self.workload = workload
        self.config = config
        self.traffic = traffic
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        self.device_events: Dict[str, list] = {}
        self.counters: Dict[str, float] = {}
        self.notes: Dict[str, object] = {}
        self.profile = None  # portbench.core.profiling.Profile of the traced stretch

    def add_span(self, name: str, start: float, end: float) -> None:
        self.spans.setdefault(name, []).append((start, end))

    def device_ms(self, name: str) -> List[float]:
        """The elapsed ms of each recorded CUDA event pair of ``name``
        (synchronizes on the last one)."""
        pairs = self.device_events.get(name, [])
        if pairs:
            pairs[-1][1].synchronize()
        return [a.elapsed_time(b) for a, b in pairs]


def timed_method(record: Record, obj, attr: str, span: str) -> contextlib.AbstractContextManager:
    """Within the block, every call of ``obj.attr`` adds a host span."""
    original = getattr(obj, attr)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return original(*args, **kwargs)
        finally:
            record.add_span(span, t0, time.perf_counter())

    return _shadow(obj, attr, wrapper)


@contextlib.contextmanager
def _shadow(obj, attr: str, value):
    had = attr in vars(obj)
    old = vars(obj).get(attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        if had:
            setattr(obj, attr, old)
        else:
            delattr(obj, attr)


@contextlib.contextmanager
def replaced(module, attr: str, make: Callable[[Callable], Callable]):
    """Within the block, ``module.attr`` is ``make(original)``."""
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield original
    finally:
        setattr(module, attr, original)


@contextlib.contextmanager
def device_span(record: Record, module, name: str):
    """Within the block, each forward of ``module`` records a CUDA event
    before and after it on the current stream."""
    import torch

    pending: List[Optional[torch.cuda.Event]] = [None]

    def pre(_mod, _inp):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        pending[0] = ev

    def post(_mod, _inp, _out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        record.device_events.setdefault(name, []).append((pending[0], ev))

    h1 = module.register_forward_pre_hook(pre)
    h2 = module.register_forward_hook(post)
    try:
        yield
    finally:
        h1.remove()
        h2.remove()
