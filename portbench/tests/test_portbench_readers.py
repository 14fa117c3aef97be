"""The metric readers and the profile's arithmetic on records made by hand."""

import pytest

from portbench.core.manifest import Manifest
from portbench.core.profiling import DeviceOp, Profile
from portbench.core.record import Record
from portbench.tests.conftest import ROOT

MS = 1_000_000  # ns


def _profile():
    ops = [DeviceOp("short_attn_tc_kernel<64, 4>", 0, 2 * MS // 100),
           DeviceOp("gemm", 1 * MS, 2 * MS), DeviceOp("gemm", 2 * MS, 2 * MS),
           DeviceOp("short_attn_tc_kernel<64, 4>", 6 * MS, 4 * MS // 100)]
    spans = [("pb:stretch", 0, 10 * MS), ("pb:enqueue", 4 * MS, 5 * MS)]
    return Profile(window_s=0.010, ops=ops, spans=spans, launches=[1, 2, 3, 4 * MS + 5],
                   stretch=(0, 10 * MS))


def test_profile_arithmetic():
    p = _profile()
    assert p.busy_intervals() == [(0, 2 * MS // 100), (1 * MS, 4 * MS), (6 * MS, 6 * MS + 4 * MS // 100)]
    assert p.busy_s == pytest.approx((0.02 + 3 + 0.04) / 1e3)
    assert p.idle_share == pytest.approx(1 - 3.06 / 10)
    gaps = dict(p.idle_gaps())
    assert gaps["pb:enqueue"] == pytest.approx(0.002)
    assert gaps["pb:stretch"] == pytest.approx(0.010 - 0.00306 - 0.002)
    assert p.breakdown()["device_ops"][0][0] == "gemm"


def _record(workload):
    m = Manifest(ROOT)
    w = m.workload(workload)
    return m, Record(workload, m.config(w["config"]), m.traffic(w["traffic"]))


def test_extract_readers():
    m, rec = _record("vitb32-extract-waterbirds")
    for i in range(40):
        rec.add_span("enqueue", i * 0.02, i * 0.02 + 0.005)
    rec.add_span("enqueue", 0.81 + 0.2, 0.81 + 0.205)  # one stall of 0.2 s
    rec.profile = _profile()
    rec.notes.update(imgs_per_s=10000.0, image_flops=8.8e9, dtype="bfloat16",
                     attention={"b": 256, "s": 50, "d": 768, "h": 12, "causal": False})
    read = {x["name"]: m.metric_reader(x["name"]).read(rec) for x in m.per_layer(rec.workload)}
    assert read["runner_enqueue_ms.extract"] == pytest.approx(5.0)
    assert read["batch_interval_p95_ms.extract"] == pytest.approx(20.0)
    assert read["mfu.extract"] == pytest.approx(100 * 8.8e13 / 989e12)
    assert read["device_idle_share.extract"] == pytest.approx(100 * (1 - 0.306))
    # the bound over the mean of the two launches (0.2 and 0.4 ms... scaled)
    mean_ms = (0.02 + 0.04) / 2
    assert read["short_attention_roofline.extract"] == pytest.approx(
        100 * 4 * 256 * 50 * 768 * 2 / 3.35e12 * 1e3 / mean_ms)
    assert read["image_tower_ms.extract"] is None  # no device events recorded


SWEEP_READERS = ("launches_per_step.sweep", "step_device_ms.sweep", "device_idle_share.sweep",
                 "mfu.sweep")


def test_sweep_readers():
    # the sweep cells wait under Open questions; their readers are ready
    m = Manifest(ROOT)
    rec = Record("rn50-sweep-waterbirds", m.config("clip-rn50"), m.traffic("waterbirds-grid48"))
    rec.profile = _profile()
    rec.notes.update(stretch_steps=2, train_flops=6.7e12, window_s=10.0)
    read = {name: m.metric_reader(name).read(rec) for name in SWEEP_READERS}
    assert read["device_idle_share.sweep"] == pytest.approx(100 * (1 - 0.306))
    assert read["launches_per_step.sweep"] == 2
    assert read["step_device_ms.sweep"] == pytest.approx(3.06 / 2)
    assert read["mfu.sweep"] == pytest.approx(1.0)


def test_readers_find_nothing_without_a_trace():
    m, rec = _record("rn50-extract-celeba")
    assert all(m.metric_reader(x["name"]).read(rec) is None for x in m.per_layer(rec.workload))
