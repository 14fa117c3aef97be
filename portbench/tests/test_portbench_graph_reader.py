"""``graph_replay_share.sweep``, the reader of the program's graph counters
(``train/steps.py::StepGraphs``), on counters made by hand."""

import pytest

from portbench.tests.test_portbench_span_readers import Tracer, _record

NAME = "graph_replay_share.sweep"


def test_graph_replay_share_reads_the_counters(monkeypatch):
    counters = {"sweep.graph_replays": 9_870, "sweep.eager_steps": 30,
                "sweep.graph_captures": 6, "sweep.slots": 71680}
    m, rec = _record("rn50-sweep-waterbirds", Tracer([], counters), monkeypatch)
    assert m.metric_reader(NAME).read(rec) == pytest.approx(100 * 9_870 / 9_900)
    assert NAME in {x["name"] for x in m.per_layer(rec.workload)}
    assert NAME not in {x["name"] for x in m.per_layer("rn50-extract-celeba")}


@pytest.mark.parametrize("counters, want", [
    ({"sweep.eager_steps": 40}, 0.0),  # every step eager, as on the CPU
    ({"sweep.slots": 71680, "sweep.useful_slots": 22780}, None),  # a program before the graphs
    ({}, None),
])
def test_graph_replay_share_without_replays(monkeypatch, counters, want):
    m, rec = _record("rn50-sweep-waterbirds", Tracer([], counters), monkeypatch)
    assert m.metric_reader(NAME).read(rec) == want


@pytest.mark.parametrize("case", ["no tracer", "no profile"])
def test_graph_replay_share_finds_nothing_without_the_tracer(monkeypatch, case):
    tracer = None if case == "no tracer" else Tracer([], {"sweep.graph_replays": 5})
    m, rec = _record("rn50-sweep-waterbirds", tracer, monkeypatch, profile=case != "no profile")
    assert m.metric_reader(NAME).read(rec) is None
