"""The readers of the program's per-block spans (``block_attention_ms.extract``
and ``block_mlp_ms.extract``) on a profile and spans made by hand."""

import pytest

from portbench.core import spans as ps
from portbench.core.manifest import Manifest
from portbench.core.profiling import DeviceOp, Profile
from portbench.core.record import Record
from portbench.tests.conftest import ROOT
from portbench.tests.test_portbench_span_readers import Span, Tracer

MS = 1_000_000  # ns
READERS = ("block_attention_ms.extract", "block_mlp_ms.extract")
CELLS = ("vitl14-336-extract-celeba", "vitb32-extract-waterbirds")


def _profile():
    return Profile(window_s=0.010, ops=[DeviceOp("gemm", 1 * MS, 8 * MS)],
                   spans=[("pb:stretch", 0, 10 * MS)], launches=[], stretch=(0, 10 * MS))


def _record(workload, tracer, monkeypatch, profile=True, batches=2):
    m = Manifest(ROOT)
    w = m.workload(workload)
    rec = Record(workload, m.config(w["config"]), m.traffic(w["traffic"]))
    rec.profile = _profile() if profile else None
    if batches:
        rec.notes["stretch_batches"] = batches
    monkeypatch.setattr(ps, "tracer", lambda: tracer)
    return m, rec


def _blocks(batches, layers, attn_ms, mlp_ms):
    """Two spans a block, ``layers`` blocks a batch, inside the stretch."""
    out, t = [], 0.1
    for _ in range(batches):
        for _ in range(layers):
            out.append(Span("block.attention", int(t * MS), int((t + 0.1) * MS), 1, None, attn_ms))
            out.append(Span("block.mlp", int((t + 0.1) * MS), int((t + 0.2) * MS), 1, None,
                            mlp_ms))
            t += 0.2
    return out


@pytest.mark.parametrize("workload", CELLS)
def test_block_readers_give_ms_per_batch_of_the_stretch(monkeypatch, workload):
    spans = _blocks(batches=2, layers=24, attn_ms=0.5, mlp_ms=0.75)
    spans += [Span("block.attention", -5 * MS, -4 * MS, 1, None, 9.0),  # before the stretch
              Span("block.mlp", 9 * MS, 11 * MS, 1, None, 9.0),  # past its end
              Span("extract.tower", 0, 10 * MS, 1, None, None)]
    m, rec = _record(workload, Tracer(spans), monkeypatch)
    read = {name: m.metric_reader(name).read(rec) for name in READERS}
    assert read["block_attention_ms.extract"] == pytest.approx(24 * 0.5)
    assert read["block_mlp_ms.extract"] == pytest.approx(24 * 0.75)
    # the metrics list the ViT-L cell alone: ViT-B/32's stretch is host-bound,
    # so there a span's events would time the stream's waits for launches
    listed = {x["name"] for x in m.per_layer(workload)} & set(READERS)
    assert listed == (set(READERS) if workload == "vitl14-336-extract-celeba" else set())


@pytest.mark.parametrize("case", ["no tracer", "no profile", "no spans", "no device time",
                                  "no batch count"])
def test_block_readers_find_nothing_without_spans(monkeypatch, case):
    spans = _blocks(batches=1, layers=2, attn_ms=None if case == "no device time" else 0.5,
                    mlp_ms=None if case == "no device time" else 0.5)
    tracer = None if case == "no tracer" else Tracer([] if case == "no spans" else spans)
    m, rec = _record(CELLS[0], tracer, monkeypatch, profile=case != "no profile",
                     batches=0 if case == "no batch count" else 1)
    assert all(m.metric_reader(n).read(rec) is None for n in READERS)

