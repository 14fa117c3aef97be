"""Stacked Stage-B sweeps through
``debiasing_multi_modal_tpu_torch.sweep.vmap_loop.train_seeds_vmapped`` with
``cell_grid`` (the call ``cli/sweep_main.py`` makes with every stack flag).

Set-up draws the embedding cache on the device, builds the bundle, the grid
of cell configurations (batch size outer, reg batch size, learning rate
inner, every seed in each) and each row's initial weights, and warms up:
``warmup: "sweep"`` runs one whole sweep, ``warmup: "steps"`` runs the first
epoch cut to ``warmup_steps`` stacked steps (train and eval) and stops.  The
warm-up sweep is recorded at the boundary of its stacked epochs for the
comparison with the reference (``checks/sweep.py``).

The window (``window`` in the traffic file):

- ``whole_sweeps``: sweeps back to back; the window ends with the sweep that
  is running when ``--seconds`` have passed;
- ``whole_epochs``: sweeps whose epochs start until ``--seconds`` have
  passed; the window ends where the next epoch would have begun.

The rate is every embedding row trained (padded rows left out), summed over
rows, phases and epochs completed in the window, over the window's time.

The boundary is ``train_epoch_vmapped`` and ``eval_epoch_vmapped`` as
``vmap_loop`` calls them: a wrapper there counts each epoch's rows, stops a
sweep at the window's end, cuts the warm-up's epochs short and, in a traced
run, profiles a stretch of steps.  Inside a recorded epoch, wrappers on
``train.steps._sgd_stacked`` and ``masked_cross_entropy`` keep the first
steps' momentum, parameters and losses.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np

from portbench.checks import sweep as checks
from portbench.checks.common import against
from portbench.core import record as rec
from portbench.core.cell import Context, Outcome
from portbench.core.inputs import adapter_inits, embedding_cache
from portbench.core.profiling import SPAN_PREFIX, profile_stretch
from portbench.reference.stage_b import grid_rows, reg_split

MA_KEY = "new_adapter.layers.0.weight"


class WindowClosed(Exception):
    """Raised at the start of an epoch once the window is over."""


class StretchDone(Exception):
    """Raised once the profiled stretch has run."""


def _clone(tree: Dict) -> Dict:
    return {k: v.detach().clone() for k, v in tree.items()}


def _cut(n: int, idx, mask, lrs, active):
    lrs = lrs[..., :n]
    return idx[:, :n], mask[:, :n], lrs, None if active is None else active[:, :n]


class Probe:
    """The wrappers' shared state for one sweep call at a time."""

    def __init__(self):
        self.deadline: Optional[float] = None
        self.max_epochs: Optional[int] = None
        self.truncate: Optional[int] = None
        self.recording = False
        self.stretch: Optional[tuple] = None
        self.epochs: List[tuple] = []  # (phase, mask, classes) per completed train epoch
        self.calls = 0  # train epochs begun in the current sweep
        self.rec: Dict[int, checks.Recording] = {}
        self.last_phase1: Optional[Dict] = None
        self.active: Optional[checks.Recording] = None
        self.profile = None
        self.stretch_steps = 0

    def begin_sweep(self):
        self.calls = 0

    # ------------------------------------------------------------ wrappers --
    def train(self, original):
        def wrapper(state, emb, labels, groups, idx, mask, lrs, text, train_mask, **kw):
            if self.deadline is not None and time.perf_counter() >= self.deadline:
                raise WindowClosed
            if self.max_epochs is not None and self.calls >= self.max_epochs:
                raise WindowClosed
            self.calls += 1
            phase = 2 if MA_KEY in state.params else 1
            if self.truncate:
                idx, mask, lrs, kw["active"] = _cut(self.truncate, idx, mask, lrs, kw.get("active"))
            if self.recording and phase not in self.rec:
                r = self.active = self.rec[phase] = checks.Recording(phase)
                r.p0, r.b0 = _clone(state.params), _clone(state.buffers)
            args = (state, emb, labels, groups, idx, mask, lrs, text, train_mask)
            try:
                if self.stretch is not None and self.stretch[0] == phase:
                    n = self.stretch[1]
                    idx, mask, lrs, kw["active"] = _cut(n, idx, mask, lrs, kw.get("active"))
                    args = (state, emb, labels, groups, idx, mask, lrs, text, train_mask)
                    with _annotations():
                        _, self.profile = profile_stretch(lambda: original(*args, **kw))
                    self.stretch_steps = idx.shape[1]
                    raise StretchDone
                out = original(*args, **kw)
            finally:
                r, self.active = self.active, None
            if r is not None and r.phase == phase and not r.params:
                r.params = _clone(out[0].params)  # fewer steps than the check follows
            if self.recording and phase == 1:
                self.last_phase1 = {**_clone(out[0].params), **_clone(out[0].buffers)}
            self.epochs.append((phase, mask, text.shape[1]))
            return out
        return wrapper

    def evaluate(self, original):
        def wrapper(state, emb, labels, groups, idx, mask, text, **kw):
            if self.truncate:
                idx, mask = idx[:self.truncate], mask[:self.truncate]
            return original(state, emb, labels, groups, idx, mask, text, **kw)
        return wrapper

    def sgd(self, original):
        def wrapper(params, grads, trace, neg_lr, momentum, weight_decay, live, active):
            original(params, grads, trace, neg_lr, momentum, weight_decay, live, active)
            r = self.active
            if r is not None:
                r.steps += 1
                if r.steps == 1:
                    r.trace1 = {n: trace[n].detach().clone() for n in live}
                if r.steps == checks.CHECK_STEPS:
                    r.params = _clone(params)
        return wrapper

    def loss(self, original):
        def wrapper(logits, labels, mask=None, count=None):
            out = original(logits, labels, mask, count)
            r = self.active
            if r is not None and len(r.losses) < checks.CHECK_STEPS:
                r.losses.append(out.detach().clone())
            return out
        return wrapper


@contextlib.contextmanager
def installed(probe: Probe):
    from debiasing_multi_modal_tpu_torch.sweep import vmap_loop
    from debiasing_multi_modal_tpu_torch.train import steps

    with rec.replaced(vmap_loop, "train_epoch_vmapped", probe.train), \
            rec.replaced(vmap_loop, "eval_epoch_vmapped", probe.evaluate), \
            rec.replaced(steps, "_sgd_stacked", probe.sgd), \
            rec.replaced(steps, "masked_cross_entropy", probe.loss):
        yield


@contextlib.contextmanager
def _annotations():
    """Profiler spans around the parts of a stacked step, for labelling the
    device's idle gaps: forward, loss, backward, update, meters."""
    import torch
    from torch.profiler import record_function

    from debiasing_multi_modal_tpu_torch.train import steps

    def span(name):
        def make(original):
            def wrapper(*args, **kwargs):
                with record_function(SPAN_PREFIX + name):
                    return original(*args, **kwargs)
            return wrapper
        return make

    with rec.replaced(steps, "stacked_logits", span("forward")), \
            rec.replaced(steps, "masked_cross_entropy", span("loss")), \
            rec.replaced(torch.autograd, "grad", span("backward")), \
            rec.replaced(steps, "_sgd_stacked", span("update")), \
            rec.replaced(steps.EpochStats, "add_stacked", span("meters")):
        yield


def make_data(ctx: Context):
    """(bundle, host view of the splits for the reference, texts)."""
    from debiasing_multi_modal_tpu_torch.train.loop import DataBundle, SplitArrays

    tr = ctx.traffic
    splits, texts = embedding_cache(ctx.seed, ctx.config["embed_dim"], tr["sizes"], tr["spec"],
                                    ctx.device)
    arrays = {}
    for name, (emb, y, place, y_pred) in splits.items():
        arrays[name] = SplitArrays(emb=emb, y=y, place=place, group=(2 * y + place).astype(np.int32),
                                   y_pred=y_pred)
    g = arrays["train"].group
    bundle = DataBundle(train=arrays["train"], val=arrays["val"], test=arrays["test"],
                        text_class=texts["class"], text_spurious=texts["spurious"],
                        text_group=texts["group"],
                        train_group_ratio=np.bincount(g, minlength=4).astype(np.float32) / len(g))
    return bundle, texts


def reference_data(ctx: Context):
    """The reference's view of the same seeded cache, drawn again."""
    import torch

    splits, texts = embedding_cache(ctx.seed, ctx.config["embed_dim"], ctx.traffic["sizes"],
                                    ctx.traffic["spec"], ctx.device)
    out = {"text": texts}
    for name in ("train", "val"):
        emb, y, place, _ = splits[name]
        out[name] = {"emb": emb, "y": y, "group": (2 * y + place).astype(np.int32)}
    reg_idx, _ = reg_split(out["val"]["group"], 42)
    idx = torch.from_numpy(reg_idx.astype(np.int64)).to(ctx.device)
    out["reg"] = {"emb": out["val"]["emb"].index_select(0, idx), "y": out["val"]["y"][reg_idx],
                  "group": out["val"]["group"][reg_idx]}
    del splits
    return out


def grid(ctx: Context):
    """(base config, cell configs, row count)."""
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig

    tr = ctx.traffic
    t = dict(tr["train"])
    t["lr_decay_epochs"] = tuple(t["lr_decay_epochs"])
    base = TrainConfig(dataset=tr["dataset"], input_dim=ctx.config["embed_dim"], **t)
    g = tr["grid"]
    cells = [base.replace(batch_size=bs, batch_size_reg=bsr, learning_rate=float(lr),
                          learning_rate_reg=float(lr) * g["lr_multiple"])
             for bs in g["bs"] for bsr in g["bsr"] for lr in g["lr"]]
    return base, cells, len(grid_rows(g))


def run(ctx: Context) -> Outcome:
    import torch
    from debiasing_multi_modal_tpu_torch.sweep.vmap_loop import train_seeds_vmapped

    tr, dev = ctx.traffic, ctx.device
    bundle, _ = make_data(ctx)
    base, cells, n_rows = grid(ctx)
    hidden = tr["train"]["adapter_feat_dim"]
    inits = adapter_inits(ctx.seed, n_rows, ctx.config["embed_dim"], hidden, dev)
    seeds = tr["grid"]["seeds"]
    probe = Probe()

    def sweep():
        probe.begin_sweep()
        try:
            train_seeds_vmapped(base, bundle, seeds, cell_grid=cells, inits=inits, device=dev)
        except WindowClosed:
            return False
        return True

    with _faults(ctx.faults), installed(probe):
        probe.recording = True
        if tr["warmup"] == "steps":
            probe.truncate, probe.max_epochs = tr["warmup_steps"], 1
        sweep()
        probe.recording, probe.truncate, probe.max_epochs = False, None, None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        probe.epochs = []
        sweeps = 0
        t0 = time.perf_counter()
        if tr["window"] == "whole_epochs":
            probe.deadline = t0 + ctx.seconds
            while sweep():
                sweeps += 1
        else:
            while True:
                sweep()
                sweeps += 1
                if time.perf_counter() >= t0 + ctx.seconds:
                    break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        probe.deadline = None
        epochs = probe.epochs
        counts = torch.stack([m.sum() for _, m, _ in epochs]).cpu().numpy() if epochs else []
        samples = float(np.sum(counts))
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        if ctx.record is not None:
            _trace(ctx, probe, sweep, epochs, counts, t1 - t0)
    del bundle
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    data = reference_data(ctx)
    reference = checks.reference_steps(tr, data, inits, sorted(probe.rec), dev,
                                       program=probe.rec)
    program = checks.program_steps(probe.rec)
    found = checks.readings(program, reference)
    found["start_gap"] = checks.start_gap(probe.rec, inits,
                                          tr["train"]["epochs_feature_learning"],
                                          probe.last_phase1)
    epochs_done = len(epochs)
    return Outcome(attempted=epochs_done, failed=0,
                   end_to_end={"setup_s": t0 - ctx.t_start, "sweep_samples_per_s": samples / (t1 - t0)},
                   checks=against(ctx.limits, found), memory_peak_bytes=peak,
                   notes={"window_s": t1 - t0, "samples": samples, "sweeps": sweeps,
                          "epochs": epochs_done, "check_s": time.perf_counter() - t_check,
                          "readings": found, "recordings": probe.rec, "inits": inits,
                          "reference": reference, "data": data,
                          "worst_leaves": checks.worst_leaves(program, reference)})


def _trace(ctx: Context, probe: Probe, sweep, epochs, counts, window_s: float) -> None:
    """After the window: profile ``trace.steps`` stacked steps of the first
    epoch of phase ``trace.phase`` in a further sweep."""
    from portbench.counts.flops import adapter_train_flops

    tr, record = ctx.traffic, ctx.record
    probe.stretch = (tr["trace"]["phase"], tr["trace"]["steps"])
    try:
        sweep()
    except StretchDone:
        pass
    finally:
        probe.stretch = None
    record.profile = probe.profile
    dim, hidden = ctx.config["embed_dim"], tr["train"]["adapter_feat_dim"]
    flops = sum(float(n) * adapter_train_flops(dim, hidden, classes, phase == 2)
                for (phase, _, classes), n in zip(epochs, counts))
    record.notes.update(stretch_steps=probe.stretch_steps, train_flops=flops,
                        window_s=window_s, samples=float(np.sum(counts)))


@contextlib.contextmanager
def _faults(faults):
    """Plant the named faults under the timed path and under the probe
    (tests only): a step that leaves the state unchanged, or half of each
    batch left out and the mean taken over the rest."""
    if not faults:
        yield
        return
    from debiasing_multi_modal_tpu_torch.sweep import vmap_loop
    from debiasing_multi_modal_tpu_torch.train import steps

    def halve(original):
        def broken(state, emb, labels, groups, idx, mask, lrs, text, train_mask, **kw):
            mask = mask.clone()
            mask[..., (mask.shape[-1] + 1) // 2:] = False
            return original(state, emb, labels, groups, idx, mask, lrs, text, train_mask, **kw)
        return broken

    with contextlib.ExitStack() as stack:
        if "state_unchanged" in faults:
            stack.enter_context(rec.replaced(steps, "_sgd_stacked", lambda _: lambda *a: None))
        if "half_batch" in faults:
            stack.enter_context(rec.replaced(vmap_loop, "train_epoch_vmapped", halve))
        yield
