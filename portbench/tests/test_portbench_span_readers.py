"""The readers of the program's own spans and counters
(``core/spans.py`` and the six metrics built on it), on a profile and spans
made by hand."""

from typing import NamedTuple, Optional

import pytest

from portbench.core import spans as ps
from portbench.core.manifest import Manifest
from portbench.core.profiling import DeviceOp, Profile
from portbench.core.record import Record
from portbench.tests.conftest import ROOT

MS = 1_000_000  # ns
EXTRACT = ("input_wait_ms.extract", "preprocess_ms.extract", "dispatch_idle_share.extract",
           "drain_idle_share.extract")
SWEEP = ("step_host_ms.sweep", "padded_slot_share.sweep")


class Span(NamedTuple):  # the program's span, as utils/profiling.spans() gives it
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[int] = None
    device_ms: Optional[float] = None


class Tracer:
    def __init__(self, spans, counters=None):
        self._spans, self._counters = spans, counters or {}

    def spans(self):
        return self._spans

    def counters(self):
        return self._counters


def _ms(name, a, b, thread=1, device_ms=None):
    return Span(name, int(a * MS), int(b * MS), thread, None, device_ms)


def _profile():
    """Busy 1-3, 5-6 and 8-9 ms of a 10-ms stretch: idle 0-1, 3-5, 6-8, 9-10."""
    ops = [DeviceOp("gemm", 1 * MS, 2 * MS), DeviceOp("gemm", 5 * MS, 1 * MS),
           DeviceOp("copy", 8 * MS, 1 * MS)]
    return Profile(window_s=0.010, ops=ops, spans=[("pb:stretch", 0, 10 * MS)], launches=[],
                   stretch=(0, 10 * MS))


EXTRACT_SPANS = [
    _ms("extract.run", 0.1, 9.9),
    _ms("extract.input_wait", 0.1, 0.9),  # the pipeline's fill
    _ms("extract.enqueue", 0.9, 2.0),
    _ms("extract.preprocess", 1.0, 1.2, device_ms=0.5),
    _ms("extract.input_wait", 2.0, 2.5),
    _ms("extract.enqueue", 2.5, 4.0),
    _ms("extract.preprocess", 2.6, 2.8, device_ms=0.7),
    _ms("extract.input_wait", 4.0, 4.2),  # the end of the stream
    _ms("extract.drain", 4.2, 6.5),
    _ms("extract.drain", 6.6, 9.5),
    _ms("extract.upload", 0.2, 8.0, thread=2),  # the upload thread, not the driving one
    _ms("extract.enqueue", -5.0, -4.0),  # before the stretch
    _ms("extract.drain", 9.95, 12.0),  # past its end: a label, read by no metric
]


def _record(workload, tracer, monkeypatch, profile=True):
    m = Manifest(ROOT)
    w = m.workload(workload)
    rec = Record(workload, m.config(w["config"]), m.traffic(w["traffic"]))
    rec.profile = _profile() if profile else None
    monkeypatch.setattr(ps, "tracer", lambda: tracer)
    return m, rec


def test_extract_span_readers(monkeypatch):
    m, rec = _record("rn50-extract-celeba", Tracer(EXTRACT_SPANS), monkeypatch)
    read = {name: m.metric_reader(name).read(rec) for name in EXTRACT}
    assert read["input_wait_ms.extract"] == pytest.approx(0.5)
    assert read["preprocess_ms.extract"] == pytest.approx(0.6)
    assert read["dispatch_idle_share.extract"] == pytest.approx(100 * (0.1 + 1.0) / 10)
    assert read["drain_idle_share.extract"] == pytest.approx(100 * (0.8 + 0.5 + 1.4 + 0.5) / 10)
    assert {x["name"] for x in m.per_layer(rec.workload)} >= set(EXTRACT)


def test_idle_by_span_labels_every_idle_moment(monkeypatch):
    _, rec = _record("rn50-extract-celeba", Tracer(EXTRACT_SPANS), monkeypatch)
    got = ps.idle_by_span(rec, "extract.run")
    want = {"no program span": 0.15, "extract.input_wait": 1.0, "extract.enqueue": 1.1,
            "extract.drain": 3.25, "extract.run": 0.5}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v / 1e3), k
    assert sum(got.values()) == pytest.approx(rec.profile.window_s * (1 - 0.4))
    assert ps.idle_intervals(rec.profile) == [(0, MS), (3 * MS, 5 * MS), (6 * MS, 8 * MS),
                                              (9 * MS, 10 * MS)]
    assert ps.overlap_ns([(0, 4), (2, 6)], [(1, 2), (3, 10)]) == 1 + 3


def test_sweep_span_readers(monkeypatch):
    spans = [_ms("sweep.train", 0.0, 10.0), _ms("sweep.step", 0.5, 3.5),
             _ms("sweep.step", 4.0, 7.0)]
    tracer = Tracer(spans, {"sweep.slots": 71680, "sweep.useful_slots": 22780})
    m, rec = _record("rn50-sweep-waterbirds", tracer, monkeypatch)
    read = {name: m.metric_reader(name).read(rec) for name in SWEEP}
    assert read["step_host_ms.sweep"] == pytest.approx(3.0)
    assert read["padded_slot_share.sweep"] == pytest.approx(100 * (1 - 22780 / 71680))
    assert {x["name"] for x in m.per_layer(rec.workload)} >= set(SWEEP)


@pytest.mark.parametrize("case", ["no tracer", "no profile", "no spans"])
def test_span_readers_find_nothing_without_the_tracer(monkeypatch, case):
    tracer = {"no tracer": None, "no profile": Tracer(EXTRACT_SPANS, {"sweep.slots": 10}),
              "no spans": Tracer([], {})}[case]
    for workload, names in (("vitb32-extract-waterbirds", EXTRACT),
                            ("rn50-sweep-waterbirds", SWEEP)):
        m, rec = _record(workload, tracer, monkeypatch, profile=case != "no profile")
        assert all(m.metric_reader(n).read(rec) is None for n in names)


def test_a_program_without_the_tracer_reads_as_none(monkeypatch):
    from debiasing_multi_modal_tpu_torch.utils import profiling

    assert ps.tracer() is profiling
    monkeypatch.delattr(profiling, "spans")  # as the program before its tracer
    assert ps.tracer() is None
