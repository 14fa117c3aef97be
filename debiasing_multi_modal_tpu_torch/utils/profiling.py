"""Profiling for the port (counterpart of ``utils/profiling.py``).

:func:`trace` records a ``torch.profiler`` trace of a region into
``log_dir`` (TensorBoard / Chrome trace format), every thread's operators
and spans in it (the extraction's upload thread too).

The program's own spans and counters:

- :func:`annotate` is a span.  While a ``torch.profiler`` records in the
  process, it keeps the span's name, start, end, thread and parent in memory
  and opens a ``record_function`` of the same name, so the span shows in
  every trace; with ``device=True`` it also records a CUDA event pair on the
  current stream, whose time is the stream's from the block's first launch
  to its last kernel's end: the kernels' work and any wait of the stream
  for the host's next launch.  Otherwise it costs one check and enters a
  shared no-op.
  Stamps are ``time.time_ns()``, the clock of the profiler's own events.
- :func:`spanned` makes each call of a function a span.
- :func:`count` adds to a named counter; counters are always on and belong
  at epoch or batch boundaries, never inside a step.
- :func:`spans` and :func:`counters` read them back.

Spans the port opens: ``extract.run``, ``extract.input_wait``,
``extract.enqueue``, ``extract.drain``, ``extract.shard_flush``,
``extract.upload`` (the upload thread), ``extract.preprocess`` (with device
time), ``extract.tower``, ``extract.head`` (``extract/runner.py``);
``sweep.run``, ``sweep.epoch``, ``sweep.plans``, ``sweep.train``,
``sweep.eval``, ``sweep.read``, ``sweep.select`` (``sweep/vmap_loop.py``),
``sweep.step`` (``train/steps.py::train_epoch_vmapped``);
``block.attention`` and ``block.mlp`` (with device time), the two residual
branches of every transformer block of both towers
(``models/layers.py::ResidualAttentionBlock``).  Counters:
``sweep.slots`` and ``sweep.useful_slots``, the stacked rows' batch slots and
those that hold a sample, added when a ``train_seeds_vmapped`` call has run
to its end (a call cut short by an exception adds none).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch._C._profiler import _ExperimentalConfig
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the region (host, and the card when there is one) on every
    thread and write the trace into ``log_dir``; yields the profiler
    (``None`` if disabled)."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
        experimental_config=_ExperimentalConfig(profile_all_threads=True),
    ) as prof:
        yield prof


MAX_SPANS = 1 << 17  # the span buffer keeps the newest 131,072 spans

_SPANS: "collections.deque" = collections.deque(maxlen=MAX_SPANS)
_COUNTERS: Dict[str, float] = {}
_COUNTERS_LOCK = threading.Lock()
_OPEN = threading.local()  # .top: the innermost open span of this thread
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    """One finished span: ``parent`` is the index of the enclosing span of
    the same thread in the list :func:`spans` returns (None at the top, or
    when the buffer has dropped it); ``device_ms`` is the CUDA event time of
    a ``device=True`` span on the card, else None."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[int]
    device_ms: Optional[float]


class _Recording:
    """The context of one span while the profiler records.  Its entry in
    the buffer is ``[name, start, end, thread, parent entry, events]``."""

    __slots__ = ("entry", "fn", "device")

    def __init__(self, name: str, device: bool):
        self.entry = [name, 0, None, threading.get_ident(), None, None]
        self.fn = record_function(name)
        self.device = device

    def __enter__(self):
        entry = self.entry
        entry[4] = getattr(_OPEN, "top", None)
        _OPEN.top = entry
        _SPANS.append(entry)
        entry[1] = time.time_ns()
        self.fn.__enter__()
        if self.device and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            entry[5] = (start, torch.cuda.Event(enable_timing=True))
        return self

    def __exit__(self, *exc):
        entry = self.entry
        if entry[5] is not None:
            entry[5][1].record()
        self.fn.__exit__(*exc)
        entry[2] = time.time_ns()
        _OPEN.top = entry[4]
        return False


def annotate(name: str, device: bool = False):
    """A span named ``name`` around the ``with`` block: recorded, and shown
    in the profiler's trace, while a ``torch.profiler`` records in the
    process; a shared no-op context otherwise.  ``device=True`` also times
    the block on the current CUDA stream (its kernels and the stream's waits
    for their launches)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, device)


def spanned(name: str):
    """Decorator: each call of the function is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    with _COUNTERS_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> Dict[str, float]:
    """Every counter, with each kernel wrapper's launch count in this
    process as ``launches.<wrapper>`` (``ops.launch_counts``)."""
    from debiasing_multi_modal_tpu_torch.ops import launch_counts

    out = dict(_COUNTERS)
    out.update((f"launches.{k}", v) for k, v in launch_counts().items())
    return out


def spans() -> List[Span]:
    """The finished spans in the buffer, in the order they began.  Reading
    a device span's time waits for its end event on the card."""
    entries = [e for e in list(_SPANS) if e[2] is not None]
    index = {id(e): i for i, e in enumerate(entries)}
    out = []
    for e in entries:
        ms = e[5]
        if isinstance(ms, tuple):
            ms[1].synchronize()
            ms = e[5] = ms[0].elapsed_time(ms[1])
        parent = None if e[4] is None else index.get(id(e[4]))
        out.append(Span(e[0], e[1], e[2], e[3], parent, ms))
    return out
