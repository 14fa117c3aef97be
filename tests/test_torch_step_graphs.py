"""The stacked Stage-B steps replayed as CUDA graphs (train/steps.py:
``StepGraphs``, ``_stacked_steps``).

On the CPU the steps run eagerly and nothing is captured; the replay path's
binding of static inputs (the call's state and meters copied in at the first
graph step, each step's plan slice before its replay, the state and meters
copied back after the last; the split read in place) is held to the eager
steps by a stand-in graph that re-runs the step's Python on the static
inputs.  On a card (the ``on_card`` tests, skipped here; run them with
``python -m pytest --noconftest tests/test_torch_step_graphs.py -k on_card``)
real graphs are held to steps run eagerly one by one, bit for bit, on small
grids, on the 48-row grid of ``scripts/run_sweep_wb_torch.sh`` at
Waterbirds' split sizes and D = 1024, and on the 6-row grid of
``scripts/run_sweep_ca_torch.sh``'s balanced phase at CelebA's."""

import contextlib
import types

import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_dataset
from debiasing_multi_modal_tpu_torch.models.adapter import (
    AdapterClassifier,
    LinearClassifier,
    MultipleAdapterClassifier,
)
from debiasing_multi_modal_tpu_torch.sweep import vmap_loop
from debiasing_multi_modal_tpu_torch.train import loop as tloop
from debiasing_multi_modal_tpu_torch.train import steps
from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
from debiasing_multi_modal_tpu_torch.utils import profiling

SPEC = dict(n_train=200, n_val=96, n_test=64, dim=32)
COUNTERS = ("sweep.eager_steps", "sweep.graph_captures", "sweep.graph_replays")


class StandIn(steps.StepGraphs):
    """Captures on the CPU: each replay re-runs the step's Python on the
    static inputs the capture was given."""

    def takes(self, device):
        return True

    def on_side_stream(self, device):
        return contextlib.nullcontext()

    def capture(self, fn, device):
        return types.SimpleNamespace(replay=fn)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _use(monkeypatch, graphs):
    monkeypatch.setattr(steps, "STEP_GRAPHS", graphs)
    return graphs


def _counted(fn):
    c0 = profiling.counters()
    out = fn()
    c1 = profiling.counters()
    return out, {k: c1.get(k, 0) - c0.get(k, 0) for k in COUNTERS}


def _bundle(spec=SPEC, device="cpu"):
    meta, table, tc, tg, ts = make_synthetic_dataset(SyntheticSpec(**spec))
    splits = {n: meta.take(np.where(meta.split == s)[0])
              for n, s in (("train", 0), ("val", 1), ("test", 2))}
    return tloop.bundle_from_embedding_table(table, splits, tc, ts, tg, device=device)


GRIDS = {"mixed": dict(bs=(32, 64), bsr=(8, 16)),  # mixed batch sizes: `active` is given
         "uniform": dict(bs=(32,), bsr=(8,))}
# scripts/run_sweep_wb_torch.sh's grid at Waterbirds' split sizes and D =
# 1024, its 100 epochs cut to 10 (feature learning 40 -> 4, decay at 90, 95
# -> 9, 10): 2 bs x 4 bsr x 2 lr cells x 3 seeds = 48 rows (card only)
WB = dict(spec=dict(n_train=4795, n_val=1199, n_test=5794, dim=1024), bs=(512, 1024),
          bsr=(64, 128, 256, 512), lr=(1.0, 10.0), seeds=[42, 32, 22],
          cfg=dict(adapter_feat_dim=128, epochs=10, epochs_feature_learning=4,
                   lr_decay_epochs=(9, 10), lr_decay_rate=0.1, warm_reg=True))
# scripts/run_sweep_ca_torch.sh's grid at CelebA's split sizes and D = 1024,
# only its balanced phase (as the benchmark's CelebA sweep cell runs it), 25
# epochs cut to 2: bsr 4, 8, 16 (the reg half's steps differ by row, so
# `active` is given) x 2 seeds = 6 rows (card only)
CA = dict(spec=dict(n_train=162770, n_val=19867, n_test=19962, dim=1024), bs=(1024,),
          bsr=(4, 8, 16), lr=(0.1,), lr_reg=10.0, seeds=[42, 32], dataset="celeba",
          cfg=dict(adapter_feat_dim=128, epochs=2, epochs_feature_learning=0,
                   lr_decay_epochs=(1, 2), lr_decay_rate=0.1, warm_reg=True, balance_val=True))
FULL = {"waterbirds48": WB, "celeba6": CA}


def _grid(grid):
    """(base config, the grid's cells, seeds, data spec)."""
    if grid in FULL:
        g = FULL[grid]
        spec, seeds, cfg = g["spec"], g["seeds"], g["cfg"]
    else:
        g, spec, seeds = dict(GRIDS[grid], lr=(0.5, 2.0)), SPEC, [42, 7]
        cfg = dict(adapter_feat_dim=8, epochs=3, epochs_feature_learning=1,
                   lr_decay_epochs=(100,))
    lr_reg = g.get("lr_reg", 1.0)
    base = TrainConfig(dataset=g.get("dataset", "waterbirds"), input_dim=spec["dim"],
                       batch_size=g["bs"][0], batch_size_reg=g["bsr"][0],
                       learning_rate=g["lr"][0], learning_rate_reg=g["lr"][0] * lr_reg,
                       tl_method="adapter_reg_seq_alter", add_adapter=True, **cfg)
    cells = [base.replace(batch_size=bs, batch_size_reg=bsr, learning_rate=lr,
                          learning_rate_reg=lr * lr_reg)
             for bs in g["bs"] for bsr in g["bsr"] for lr in g["lr"]]
    return base, cells, seeds, spec


def _sweep(monkeypatch, grid, device, bundle=None):
    """Each row's results, and every stacked train epoch's state and meters."""
    base, cells, seeds, spec = _grid(grid)
    epochs = []
    original = vmap_loop.train_epoch_vmapped

    def keep(*args, **kwargs):
        state, stats = original(*args, **kwargs)
        epochs.append(([v.detach().clone() for d in (state.params, state.buffers, state.trace)
                        for v in d.values()], [v.clone() for v in stats]))
        return state, stats

    with monkeypatch.context() as m:
        m.setattr(vmap_loop, "train_epoch_vmapped", keep)
        results = vmap_loop.train_seeds_vmapped(base, bundle or _bundle(spec), seeds,
                                                cell_grid=cells, device=device)
    return results, epochs


def _assert_bit_equal(a, b):
    (res_a, ep_a), (res_b, ep_b) = a, b
    assert res_a == res_b
    assert len(ep_a) == len(ep_b)
    for (state_a, stats_a), (state_b, stats_b) in zip(ep_a, ep_b):
        for x, y in zip(state_a + stats_a, state_b + stats_b):
            assert torch.equal(x, y)


# -------------------------------------------------------------- the CPU --


def test_cpu_sweep_captures_nothing_and_counts_every_step(monkeypatch):
    """On the CPU every stacked train and eval step runs eagerly, counted
    once each, and no key is even looked up."""
    graphs = _use(monkeypatch, steps.StepGraphs())
    shapes = []
    for name, nb in (("train_epoch_vmapped", lambda idx: idx.shape[1]),
                     ("eval_epoch_vmapped", lambda idx: idx.shape[0])):
        def wrap(original, nb=nb):
            def call(state, emb, labels, groups, idx, *args, **kwargs):
                shapes.append(nb(idx))
                return original(state, emb, labels, groups, idx, *args, **kwargs)
            return call
        monkeypatch.setattr(vmap_loop, name, wrap(getattr(vmap_loop, name)))
    base, cells, seeds, _ = _grid("mixed")
    _, done = _counted(lambda: vmap_loop.train_seeds_vmapped(base, _bundle(), seeds,
                                                             cell_grid=cells, device="cpu"))
    assert done == {"sweep.eager_steps": sum(shapes), "sweep.graph_captures": 0,
                    "sweep.graph_replays": 0}
    assert len(graphs) == 0 and not graphs._keys
    # phase 1 at the smallest batch (32) over 200 rows: 7 steps an epoch
    assert shapes[0] == 7 and sum(shapes) > 3 * 7


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_stand_in_replay_binds_inputs_as_the_eager_steps_do(monkeypatch, grid):
    """With a stand-in capture on the CPU, the replay path's copies in and
    out leave every train epoch's state and meters, and every row's results,
    equal bit for bit to the eager sweep's."""
    eager = _sweep(monkeypatch, grid, "cpu")
    _use(monkeypatch, StandIn())
    replayed, done = _counted(lambda: _sweep(monkeypatch, grid, "cpu"))
    assert done["sweep.graph_captures"] >= 4 and done["sweep.graph_replays"] > 0
    _assert_bit_equal(replayed, eager)


@pytest.mark.parametrize("grid", sorted(GRIDS) + sorted(FULL))
def test_replayed_sweep_is_bit_equal_to_eager_steps_on_card(monkeypatch, card, grid):
    """The graph path against every step run eagerly (a warm-up no key
    outlasts), on a grid with ``active`` and one without, on the user's
    48-row Waterbirds grid and on the 6-row CelebA grid's balanced phase
    over 162,770 rows: each train epoch's parameters, buffers, momentum and
    meters, and every row's results, are bit-equal.  A key that a sweep
    uses for exactly the warm-up's three steps (the small grids' phase-1
    validation) is captured in the next sweep; from then on no step runs
    eagerly (a split staged elsewhere than before is captured at once)."""
    _, _, _, spec = _grid(grid)
    bundle = _bundle(spec, card)
    _use(monkeypatch, steps.StepGraphs(warmup=10**9))
    eager, done = _counted(lambda: _sweep(monkeypatch, grid, card, bundle))
    assert done["sweep.graph_captures"] == done["sweep.graph_replays"] == 0
    _use(monkeypatch, steps.StepGraphs())
    runs = [_counted(lambda: _sweep(monkeypatch, grid, card, bundle)) for _ in range(3)]
    for got, _ in runs:
        _assert_bit_equal(got, eager)
    assert runs[0][1]["sweep.graph_captures"] >= 4 and runs[0][1]["sweep.graph_replays"] > 0
    assert runs[2][1]["sweep.eager_steps"] == 0 and runs[2][1]["sweep.graph_replays"] > 0


# ----------------------------------------------------------------- keys --

D, H = 8, 4


def _state(kind, rows, device):
    make = {"adapter": lambda g: AdapterClassifier(D, H, generator=g),
            "multiple": lambda g: MultipleAdapterClassifier(D, H, generator=g),
            "linear": lambda g: LinearClassifier(D, 2, generator=g)}[kind]
    return steps.StackedState.stack([make(torch.Generator().manual_seed(k)) for k in range(rows)],
                                    device)


SPLITS = {}


def _split(n, classes, device):
    """Seeded (embeddings, labels, groups, text), one resident copy each."""
    got = SPLITS.get((n, classes, str(device)))
    if got is None:
        g = torch.Generator().manual_seed(n * 10 + classes)
        got = SPLITS[(n, classes, str(device))] = (
            torch.randn(n, D, generator=g).to(device),
            torch.randint(0, classes, (n,), generator=g).to(device),
            torch.randint(0, 4, (n,), generator=g).to(device),
            torch.randn(D, classes, generator=g).to(device))
    return got


def _epoch(device, nb=5, rows=2, batch=8, n=40, classes=2, active=False, kind="adapter",
           momentum=0.9, moved=False):
    """One stacked train epoch of ``nb`` steps on seeded plans over a
    resident split (``moved``: a fresh copy of it, elsewhere in memory);
    returns the counters it moved."""
    g = torch.Generator().manual_seed(0)
    split = _split(n, classes, device)
    emb, labels, groups, text = [t.clone() for t in split] if moved else split
    idx = torch.randint(0, n, (rows, nb, batch), generator=g).to(device)
    mask = (torch.rand(rows, nb, batch, generator=g) < 0.9).to(device)
    act = torch.ones(rows, nb, dtype=torch.bool, device=device) if active else None
    state = _state(kind, rows, device)
    lrs = torch.full((nb,), 0.1, device=device)
    _, done = _counted(lambda: steps.train_epoch_vmapped(
        state, emb, labels, groups, idx, mask, lrs, text, steps.ones_mask(state.params),
        active=act, momentum=momentum))
    assert sum(done.values()) == nb
    return done


def _holds_keys(device):
    base = _epoch(device)
    assert base == {"sweep.eager_steps": 3, "sweep.graph_captures": 1, "sweep.graph_replays": 1}
    assert _epoch(device) == {"sweep.eager_steps": 0, "sweep.graph_captures": 0,
                              "sweep.graph_replays": 5}
    for change in (dict(rows=3), dict(batch=6), dict(n=30), dict(classes=3), dict(active=True),
                   dict(kind="multiple"), dict(kind="linear"), dict(momentum=0.5)):
        assert _epoch(device, **change)["sweep.graph_captures"] == 1, change
    # a key used fewer times than the warm-up is never captured
    assert _epoch(device, nb=2, batch=4)["sweep.graph_captures"] == 0
    assert _epoch(device, nb=1, batch=4)["sweep.graph_captures"] == 0
    assert _epoch(device, nb=1, batch=4) == {"sweep.eager_steps": 0, "sweep.graph_captures": 1,
                                             "sweep.graph_replays": 0}
    # a warm key with its split elsewhere captures at once; the first
    # placement's graph is still there
    assert _epoch(device, moved=True) == {"sweep.eager_steps": 0, "sweep.graph_captures": 1,
                                          "sweep.graph_replays": 4}
    assert _epoch(device)["sweep.graph_replays"] == 5


def test_each_key_field_makes_a_new_capture_with_a_stand_in(monkeypatch):
    graphs = _use(monkeypatch, StandIn())
    _holds_keys(torch.device("cpu"))
    assert len(graphs) == 11


def test_each_key_field_makes_a_new_capture_on_card(monkeypatch, card):
    graphs = _use(monkeypatch, steps.StepGraphs())
    _holds_keys(card)
    assert len(graphs) == 11


def test_keys_of_one_structure_share_their_static_inputs(monkeypatch):
    """Keys that differ only in the split, the text columns or the
    hyperparameters share one set of static copies; another state or batch
    shape has its own."""
    graphs = _use(monkeypatch, StandIn())
    cpu = torch.device("cpu")
    for change in ({}, dict(n=30), dict(classes=3), dict(momentum=0.5), dict(rows=3),
                   dict(batch=6)):
        _epoch(cpu, **change)
    statics = [k.statics for k in graphs._keys.values()]
    assert len(statics) == 6 and all(s is statics[0] for s in statics[:4])
    assert len({id(s) for s in statics}) == 3


def test_the_cache_keeps_its_most_recent_keys(monkeypatch):
    graphs = _use(monkeypatch, StandIn(capacity=2))
    for batch in (8, 6, 4):
        _epoch(torch.device("cpu"), batch=batch)
    assert len(graphs) == 2
    assert _epoch(torch.device("cpu"), batch=8)["sweep.graph_captures"] == 1  # evicted
    assert _epoch(torch.device("cpu"), batch=4)["sweep.graph_captures"] == 0


def test_a_key_keeps_its_most_recent_split_placements(monkeypatch):
    """A key holds a graph for each of its last two placements of the split
    (``StepGraphs.ADDRESSES``); a third evicts the oldest, which then
    captures anew with no warm-up."""
    graphs = _use(monkeypatch, StandIn())
    assert graphs.ADDRESSES == 2
    cpu = torch.device("cpu")
    first = _split(40, 2, cpu)
    second, third = (tuple(t.clone() for t in first) for _ in range(2))

    def on(split):
        monkeypatch.setitem(SPLITS, (40, 2, "cpu"), split)
        return _epoch(cpu)

    assert on(first)["sweep.graph_captures"] == 1
    assert on(second)["sweep.graph_captures"] == 1
    assert on(third)["sweep.graph_captures"] == 1  # evicts the first's graph
    assert len(graphs) == 2
    assert on(second)["sweep.graph_replays"] == 5
    assert on(first) == {"sweep.eager_steps": 0, "sweep.graph_captures": 1,
                         "sweep.graph_replays": 4}
