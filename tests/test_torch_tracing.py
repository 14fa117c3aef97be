"""The port's spans and counters (debiasing_multi_modal_tpu_torch/utils/
profiling.py: ``annotate``, ``spans``, ``count``, ``counters``) and where the
program opens them: ``ExtractionRunner.run`` (extract/runner.py), the stacked
sweep (sweep/vmap_loop.py, train/steps.py::train_epoch_vmapped), and the
traces that ``trace`` writes (``extract_main`` and ``sweep_main
--profile_dir``).

Spans are recorded only while a ``torch.profiler`` records; each has a
``record_function`` twin in the profiler's events, on the same clock.  The
counters are always on.  Tracing changes no output bit."""

import math
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from debiasing_multi_modal_tpu_torch import ops
from debiasing_multi_modal_tpu_torch.data.samplers import stratified_split_indices
from debiasing_multi_modal_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_dataset
from debiasing_multi_modal_tpu_torch.extract.runner import ExtractionRunner
from debiasing_multi_modal_tpu_torch.models import CLIPConfig, create_clip
from debiasing_multi_modal_tpu_torch.sweep import vmap_loop
from debiasing_multi_modal_tpu_torch.train import loop as tloop
from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
from debiasing_multi_modal_tpu_torch.utils import profiling

TWIN_NS = 100_000  # a span and its record_function twin agree within 100 us


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def _since(n0):
    """The spans recorded after the buffer held ``n0``, and all of them
    (parent indices point into the whole list)."""
    got = profiling.spans()
    return got[n0:], got


def test_spans_are_off_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function opened with tracing off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    n0 = len(profiling.spans())
    off = profiling.annotate("off.a")
    assert off is profiling.annotate("off.b", device=True)  # one shared no-op
    with off:
        torch.ones(4).sum()
    with profiling.annotate("off.c"):
        with profiling.annotate("off.d", device=True):
            torch.ones(4).sum()
    assert len(profiling.spans()) == n0


def test_spans_record_under_the_profiler_beside_their_twins():
    n0 = len(profiling.spans())
    with _recording() as prof:
        # a profile's first record_function looks its operator up (~0.1-0.3
        # ms before the profiler stamps it): a warm-up span, left out below
        with profiling.annotate("t.warm"):
            pass
        with profiling.annotate("t.outer"):
            for _ in range(2):
                with profiling.annotate("t.inner", device=True):
                    torch.ones(256).sum()
    new, every = _since(n0)
    assert [s.name for s in new] == ["t.warm", "t.outer", "t.inner", "t.inner"]
    warm, outer, a, b = new
    assert warm.parent is None and outer.parent is None
    assert every[a.parent] == outer and every[b.parent] == outer
    assert {s.thread for s in new} == {threading.get_ident()}
    assert all(s.device_ms is None for s in new)  # no card: no device time
    assert outer.start_ns <= a.start_ns <= a.end_ns <= b.start_ns <= b.end_ns <= outer.end_ns
    twins = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("t.")]
    twins.sort(key=lambda e: e.start_ns())
    assert [e.name() for e in twins] == [s.name for s in new]
    for span, twin in zip(new[1:], twins[1:]):
        assert abs(span.start_ns - twin.start_ns()) < TWIN_NS
        assert abs(span.end_ns - (twin.start_ns() + twin.duration_ns())) < TWIN_NS
    assert len(profiling.spans()) == n0 + 4  # nothing recorded once the profiler stopped
    with profiling.annotate("t.after"):
        pass
    assert len(profiling.spans()) == n0 + 4


def test_parents_stay_within_their_thread():
    n0 = len(profiling.spans())
    seen = {}

    def worker():
        seen["thread"] = threading.get_ident()
        with profiling.annotate("p.worker"):
            with profiling.annotate("p.worker_child"):
                pass

    with _recording():
        with profiling.annotate("p.main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
            with profiling.annotate("p.main_child"):
                pass
    new, every = _since(n0)
    by = {s.name: s for s in new}
    assert set(by) == {"p.main", "p.worker", "p.worker_child", "p.main_child"}
    assert by["p.main"].thread == by["p.main_child"].thread == threading.get_ident()
    assert by["p.worker"].thread == by["p.worker_child"].thread == seen["thread"]
    assert seen["thread"] != threading.get_ident()
    assert by["p.worker"].parent is None  # not the main thread's open span
    assert every[by["p.worker_child"].parent] == by["p.worker"]
    assert every[by["p.main_child"].parent] == by["p.main"]


def test_counters_are_always_on_and_carry_the_launch_counts():
    before = profiling.counters().get("c.test", 0)
    profiling.count("c.test", 3)
    profiling.count("c.test")
    got = profiling.counters()
    assert got["c.test"] == before + 4
    for name, n in ops.launch_counts().items():
        assert got[f"launches.{name}"] == n


# ------------------------------------------------------------- extraction --

TINY_VIT = dict(name="tiny-vit", embed_dim=32, image_resolution=32, vision_layers=1,
                vision_width=64, vision_patch_size=16, transformer_width=64,
                transformer_heads=2, transformer_layers=1)


def _extract(runner, pool, depth):
    metas = [{k: np.full(len(b), i, np.int32) for k in ("y", "place", "group", "split")}
             for i, b in enumerate(pool)]
    for i, m in enumerate(metas):
        m["filenames"] = np.asarray([f"b{i}_{j}" for j in range(len(pool[i]))])
    return runner.run(zip(pool, metas), prefetch_depth=depth, upload_depth=depth,
                      max_in_flight=1)


@pytest.mark.parametrize("depth", [0, 2])
def test_extraction_run_spans_each_batch(depth):
    model = create_clip(CLIPConfig(**TINY_VIT), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    runner = ExtractionRunner(model, np.random.default_rng(0).standard_normal((2, 32)))
    rng = np.random.default_rng(1)
    pool = [rng.integers(0, 256, (3, 40, 36, 3), dtype=np.uint8) for _ in range(4)]
    plain = _extract(runner, pool, depth)
    n0 = len(profiling.spans())
    with _recording():
        traced = _extract(runner, pool, depth)
    new, every = _since(n0)
    for field in ("embeddings", "y_pred", "filenames", "y"):
        assert np.array_equal(getattr(plain, field), getattr(traced, field))
    (run,) = [s for s in new if s.name == "extract.run"]
    main = [s for s in new if s.thread == run.thread]
    names = [s.name for s in main]
    n = len(pool)
    assert names.count("extract.input_wait") == n + 1  # the last finds the end
    for name in ("extract.enqueue", "extract.drain", "extract.preprocess", "extract.tower",
                 "extract.head"):
        assert names.count(name) == n, name
    for s in main:
        if s.name in ("extract.input_wait", "extract.enqueue", "extract.drain"):
            assert every[s.parent] == run
        if s.name in ("extract.preprocess", "extract.tower", "extract.head"):
            assert every[s.parent].name == "extract.enqueue"
    uploads = [s for s in new if s.name == "extract.upload"]
    assert len(uploads) == n
    if depth:  # on the upload thread, at the top of its own stack
        assert {s.thread for s in uploads} != {run.thread}
        assert all(s.parent is None for s in uploads)
    else:  # inside each enqueue
        assert all(every[s.parent].name == "extract.enqueue" for s in uploads)


def test_extraction_trace_holds_the_upload_thread(tmp_path):
    """``trace`` (``extract_main --profile_dir``) profiles every thread: the
    Chrome trace it writes holds each batch's ``extract.upload``, on a
    thread other than the one that runs ``extract.run``."""
    import json

    model = create_clip(CLIPConfig(**TINY_VIT), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    runner = ExtractionRunner(model, np.random.default_rng(0).standard_normal((2, 32)))
    rng = np.random.default_rng(2)
    pool = [rng.integers(0, 256, (3, 40, 36, 3), dtype=np.uint8) for _ in range(3)]
    with profiling.trace(str(tmp_path)):
        _extract(runner, pool, 2)
    (name,) = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    tids = {}
    for e in events:
        if e.get("name") in ("extract.run", "extract.upload"):
            tids.setdefault(e["name"], []).append(e["tid"])
    assert len(tids["extract.run"]) == 1 and len(tids["extract.upload"]) == len(pool)
    assert set(tids["extract.upload"]).isdisjoint(tids["extract.run"])


# ------------------------------------------------------------------ sweep --

SPEC = dict(n_train=200, n_val=96, n_test=64, dim=32)
GRID = dict(bs=(32, 64), bsr=(8, 16))


def _bundle():
    meta, table, tc, tg, ts = make_synthetic_dataset(SyntheticSpec(**SPEC))
    splits = {n: meta.take(np.where(meta.split == s)[0])
              for n, s in (("train", 0), ("val", 1), ("test", 2))}
    return tloop.bundle_from_embedding_table(table, splits, tc, ts, tg, device="cpu")


def _grid():
    base = TrainConfig(dataset="waterbirds", input_dim=SPEC["dim"], adapter_feat_dim=8,
                       batch_size=GRID["bs"][0], batch_size_reg=GRID["bsr"][0],
                       learning_rate=0.5, learning_rate_reg=0.5, lr_decay_epochs=(100,),
                       tl_method="adapter_reg_seq_alter", add_adapter=True, epochs=3,
                       epochs_feature_learning=1)
    cells = [base.replace(batch_size=bs, batch_size_reg=bsr)
             for bs in GRID["bs"] for bsr in GRID["bsr"]]
    return base, cells


def test_sweep_counts_slots_and_spans_each_step():
    """Phase 1 trains on the train split at each row's ``batch_size``, phase
    2 on the reg split at its ``batch_size_reg``; the stacked plans pad to
    the longest epoch and the widest batch (``_pad_stack_plans``)."""
    bundle, (base, cells) = _bundle(), _grid()
    seeds = [42, 7]
    rows = len(cells) * len(seeds)
    n_reg = len(stratified_split_indices(bundle.val.group, 0.5, seed=42)[0])
    phases = [(SPEC["n_train"], GRID["bs"])] * base.epochs_feature_learning
    phases += [(n_reg, GRID["bsr"])] * (base.epochs - base.epochs_feature_learning)
    slots = sum(rows * math.ceil(n / min(bs)) * max(bs) for n, bs in phases)
    useful = sum(rows * n for n, _ in phases)
    steps = sum(math.ceil(n / min(bs)) for n, bs in phases)

    run = lambda: vmap_loop.train_seeds_vmapped(base, bundle, seeds, cell_grid=cells,  # noqa
                                                device="cpu")
    c0 = profiling.counters()
    plain = run()
    c1 = profiling.counters()
    assert c1.get("sweep.slots", 0) - c0.get("sweep.slots", 0) == slots
    assert c1.get("sweep.useful_slots", 0) - c0.get("sweep.useful_slots", 0) == useful
    assert useful < slots  # the grid mixes batch sizes: padding is there to count
    n0 = len(profiling.spans())
    with _recording():
        traced = run()
    assert traced == plain
    new, every = _since(n0)
    names = [s.name for s in new]
    assert names.count("sweep.run") == 1 and names.count("sweep.epoch") == base.epochs
    assert names.count("sweep.step") == steps
    assert names.count("sweep.read") == names.count("sweep.select") == base.epochs
    assert names.count("sweep.train") == base.epochs
    for s in new:
        if s.name == "sweep.step":
            assert [every[s.parent].name, every[every[s.parent].parent].name] == \
                ["sweep.train", "sweep.epoch"]
        if s.name in ("sweep.train", "sweep.eval", "sweep.read", "sweep.select"):
            assert every[s.parent].name in ("sweep.epoch", "sweep.run")
    assert {s.thread for s in new} == {threading.get_ident()}


def test_a_cut_sweep_counts_no_slots(monkeypatch):
    """The slot counters take a sweep's plans once the call has run to its
    end: a sweep stopped by an exception in its second epoch adds none."""
    class Cut(Exception):
        pass

    bundle, (base, cells) = _bundle(), _grid()
    original, calls = vmap_loop.train_epoch_vmapped, []

    def stop_in_epoch_two(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise Cut
        return original(*args, **kwargs)

    monkeypatch.setattr(vmap_loop, "train_epoch_vmapped", stop_in_epoch_two)
    c0 = profiling.counters()
    with pytest.raises(Cut):
        vmap_loop.train_seeds_vmapped(base, bundle, [42], cell_grid=cells, device="cpu")
    c1 = profiling.counters()
    assert len(calls) == 2
    for name in ("sweep.slots", "sweep.useful_slots"):
        assert c1.get(name, 0) == c0.get(name, 0), name


def test_sweep_cli_writes_a_profile(tmp_path, monkeypatch):
    from debiasing_multi_modal_tpu_torch.cli import sweep_main

    monkeypatch.setattr(tloop, "bundle_from_files", lambda *a, **kw: _bundle())
    flags = ["--dataset", "waterbirds", "--data_dir", "unused", "--image_embedding_dir", "x",
             "--text_embedding_dir", "x", "--text_spurious_embedding_dir", "x",
             "--text_group_embedding_dir", "x", "--tl_method", "adapter_reg_seq_alter",
             "--add_adapter", "--epochs", "2", "--epochs_feature_learning", "1",
             "--batch_size", "64", "--adapter_feat_dim", "8", "--lr_list", "0.5,1.0",
             "--bsr_list", "8,16", "--lr_multiple", "1.0", "--num_iter", "1",
             "--stack_lr_axis", "--stack_bsr_axis", "--device", "cpu",
             "--result_root", str(tmp_path / "results"),
             "--profile_dir", str(tmp_path / "profile")]
    parse = sweep_main.extend_parser(sweep_main.build_parser()).parse_args
    n0 = len(profiling.spans())
    assert sweep_main.main(parse(flags)) == 0
    traces = [f for f in os.listdir(tmp_path / "profile") if f.endswith(".json")]
    assert traces
    with open(tmp_path / "profile" / traces[0]) as f:
        text = f.read()
    for name in ("sweep.run", "sweep.plans", "sweep.read", "sweep.select", "sweep.eval"):
        assert f'"{name}"' in text, name
    new, _ = _since(n0)
    assert [s.name for s in new].count("sweep.epoch") == 2  # one stacked program, two epochs
    with pytest.raises(SystemExit, match="checkpoint"):
        sweep_main.main(parse(flags + ["--checkpoint_dir", str(tmp_path / "ck")]))
