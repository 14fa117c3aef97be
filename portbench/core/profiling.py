"""A profiled stretch of the program: ``torch.profiler`` over a steady
stretch, read into device busy time, kernel times by name, launches and idle
gaps labelled by the benchmark-side span the host was in.

The same pattern as the port's ``utils/profiling.py`` (kernel sums and the
idle share from the union of the device's intervals), kept here so that a
change to the program cannot move the yardstick.  Launches are the host's
kernel-launch calls in the stretch.  Host and device times come
from the profiler's own clock; the stretch's length comes from the host
clock around it, between two synchronizations.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

SPAN_PREFIX = "pb:"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel")


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int


@dataclass
class Profile:
    window_s: float
    ops: List[DeviceOp]
    spans: List[Tuple[str, int, int]]  # benchmark-side host spans (name, start, end)
    launches: List[int]  # host times of kernel-launch calls
    stretch: Tuple[int, int] = (0, 0)  # the stretch's own span on the profiler's clock

    # --------------------------------------------------------- device time --
    def busy_intervals(self) -> List[Tuple[int, int]]:
        spans = sorted((op.start_ns, op.start_ns + op.dur_ns) for op in self.ops)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s)

    def kernels(self, contains: str = "") -> List[DeviceOp]:
        return [op for op in self.ops if contains in op.name]

    def by_name(self) -> List[Tuple[str, float]]:
        sums: Dict[str, float] = {}
        for op in self.ops:
            sums[op.name] = sums.get(op.name, 0.0) + op.dur_ns / 1e9
        return sorted(sums.items(), key=lambda kv: -kv[1])

    # ------------------------------------------------------------ host side --
    def label_at(self, t: int) -> str:
        """The innermost benchmark-side span the host was in at ``t``."""
        best = None
        for n, s, e in self.spans:
            if s <= t <= e and (best is None or s >= best[1]):
                best = (n, s)
        return best[0] if best else "outside any span"

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle device time inside the stretch, summed by the span the host
        was in when each gap began, longest first."""
        lo, hi = self.stretch
        gaps: Dict[str, float] = {}
        cursor = lo
        for s, e in self.busy_intervals() + [(hi, hi)]:
            s, e = max(s, lo), min(e, hi)
            if s > cursor:
                label = self.label_at(cursor)
                gaps[label] = gaps.get(label, 0.0) + (s - cursor) / 1e9
            cursor = max(cursor, e)
        return sorted(gaps.items(), key=lambda kv: -kv[1])

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        return {"device_ops": [[n[:160], s] for n, s in self.by_name()[:top]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps()[:top]]}


def profile_stretch(fn: Callable[[], object]) -> Tuple[object, Profile]:
    """Run ``fn`` under the profiler, between two synchronizations, inside a
    ``pb:stretch`` span; return its result and the :class:`Profile`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(SPAN_PREFIX + "stretch"):
            out = fn()
            torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        prof.stop()
    return out, read_events(prof.profiler.kineto_results.events(), t1 - t0)


def read_events(events, window_s: float) -> Profile:
    """The kineto events of one profiled stretch as a :class:`Profile`."""
    from torch.autograd import DeviceType

    launches: List[int] = []
    spans: List[Tuple[str, int, int]] = []
    device = []
    stretch = (0, 0)
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name in LAUNCH_CALLS:
                launches.append(ev.start_ns())
            elif name.startswith(SPAN_PREFIX):
                span = (name, ev.start_ns(), ev.start_ns() + ev.duration_ns())
                spans.append(span)
                if name == SPAN_PREFIX + "stretch":
                    stretch = span[1:]
        elif ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation():
            device.append(ev)
    ops = [DeviceOp(ev.name(), ev.start_ns(), ev.duration_ns()) for ev in device]
    launches.sort()
    return Profile(window_s=window_s, ops=ops, spans=spans, launches=launches, stretch=stretch)
