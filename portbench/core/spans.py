"""The program's own spans and counters in a profiled stretch, for the
readers.

The program (``debiasing_multi_modal_tpu_torch/utils/profiling.py``) records
its spans while a ``torch.profiler`` records, stamped on the profiler's own
clock, so they compare directly with the stretch's device operations
(:class:`portbench.core.profiling.Profile`).  Its counters are always on.  A
program without that tracer reads as nothing: every function here returns
``None`` then, and so does every reader built on them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]


def tracer():
    """The program's profiling module when it has the tracer, else None."""
    try:
        from debiasing_multi_modal_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "spans") and hasattr(profiling, "counters")):
        return None
    return profiling


def stretch_spans(record, overlapping: bool = False) -> Optional[list]:
    """The program's finished spans that lie inside the traced stretch (with
    ``overlapping``, every one that overlaps it)."""
    t = tracer() if record.profile is not None else None
    if t is None:
        return None
    lo, hi = record.profile.stretch
    if overlapping:
        return [s for s in t.spans() if s.start_ns < hi and lo < s.end_ns]
    return [s for s in t.spans() if lo <= s.start_ns and s.end_ns <= hi]


def counters(record) -> Optional[Dict[str, float]]:
    """The program's counters, in a traced run."""
    t = tracer() if record.profile is not None else None
    return None if t is None else t.counters()


def on_thread_of(spans: Sequence, anchor: str) -> list:
    """The spans of the thread that opened ``anchor`` (the driving thread),
    in the order they began; empty without ``anchor``."""
    threads = {s.thread for s in spans if s.name == anchor}
    if len(threads) != 1:
        return []
    return sorted((s for s in spans if s.thread in threads), key=lambda s: s.start_ns)


def idle_intervals(profile) -> List[Interval]:
    """The stretch's moments with no operation on the card."""
    lo, hi = profile.stretch
    out, cursor = [], lo
    for s, e in profile.busy_intervals() + [(hi, hi)]:
        s, e = max(s, lo), min(e, hi)
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    return out


def _merged(intervals) -> List[Interval]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_ns(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """The length of the union of ``a`` within the union of ``b``."""
    a, b = _merged(a), _merged(b)
    total, j = 0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += max(0, min(e, b[k][1]) - max(s, b[k][0]))
            k += 1
    return total


def idle_share_in(record, anchor: str, name: str) -> Optional[float]:
    """Percent of the stretch in which the card ran nothing while the
    driving thread (the one that opened ``anchor``) was inside a ``name``
    span; the base is the stretch's host-clock length, as for the device's
    idle share."""
    got = stretch_spans(record)
    if not got:
        return None
    mine = [(s.start_ns, s.end_ns) for s in on_thread_of(got, anchor) if s.name == name]
    if not mine:
        return None
    idle = overlap_ns(idle_intervals(record.profile), mine)
    return 100.0 * idle / 1e9 / record.profile.window_s


def idle_by_span(record, anchor: str) -> Optional[Dict[str, float]]:
    """Idle seconds of the stretch by the innermost span the driving thread
    was in; ``"no program span"`` where it was in none."""
    got = stretch_spans(record, overlapping=True)
    if got is None:
        return None
    mine = on_thread_of(got, anchor)
    out: Dict[str, float] = {}
    for s, e in idle_intervals(record.profile):
        cuts = sorted({s, e} | {t for sp in mine for t in (sp.start_ns, sp.end_ns) if s < t < e})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            inner = None
            for sp in mine:
                if sp.start_ns <= mid <= sp.end_ns and (inner is None
                                                        or sp.start_ns >= inner.start_ns):
                    inner = sp
            label = inner.name if inner is not None else "no program span"
            out[label] = out.get(label, 0.0) + (b - a) / 1e9
    return out
