"""Multi-seed and grid training as ONE stacked program (port of
``sweep/vmap_loop.py``).

Parity surface: the reference's multi-seed scripts re-run ``train_all_epochs``
per seed in a Python loop on one GPU (run_multiple/final_main_iteration_wb.py:
1129-1140), and its grid scripts wrap that loop in lr x bs x bsr loops.  Here
every (cell, seed) row trains at once: adapter parameters are tiny (~1 MB at
D = 1024), so the rows' states stack along a leading axis
(train/steps.py ``StackedState``) and each step of an epoch issues one set of
launches for all of them, where the sequential loop issues one per row.

Row semantics mirror train/loop.py: each row has its own numpy Generator
(shuffles, balancing, resampling, contrastive rows) and its own CPU
``torch.Generator`` (initial weights), consumed in the sequential loop's
order; rows of one seed therefore share their initial weights.  ``inits``
gives the rows' initial weights instead, in ``train_all_epochs``'s ``init``
layout.  Best-model snapshots stay on the device (:class:`_Best`); the host
reads each epoch's meters once, for every row together.  Worker threads build
the rows' classifiers, the phase-2 ones while the card replays phase 1's
steps (train/steps.py ``StepGraphs``).

With a ``mesh`` the rows are sharded over its ``data`` axis, as the JAX
sweep shards its seed axis: each rank trains its contiguous rows as one
stacked program, and every row's results are gathered in row order.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from debiasing_multi_modal_tpu_torch.data.samplers import (
    balanced_subset_indices,
    cached_eval_plan,
    epoch_plan,
    resampled_ce_weights,
    stratified_split_indices,
    weighted_sample_indices,
)
from debiasing_multi_modal_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size
from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
from debiasing_multi_modal_tpu_torch.train.contrastive import train_contrastive_epoch_vmapped
from debiasing_multi_modal_tpu_torch.train.loop import (
    DataBundle,
    _tensors,
    gather_bundle,
    contrastive_epoch_rows,
    contrastive_rows_and_counts,
    make_classifier,
    make_encoder,
    make_multiple_classifier,
    move_bundle,
    zero_shot_results,
)
from debiasing_multi_modal_tpu_torch.train.metrics import ordered, results_from_counts
from debiasing_multi_modal_tpu_torch.train.schedules import epoch_batch_lrs
from debiasing_multi_modal_tpu_torch.train.steps import (
    StackedState,
    eval_epoch_vmapped,
    freeze_subtrees,
    ones_mask,
    train_epoch_vmapped,
)
from debiasing_multi_modal_tpu_torch.utils.platform import DeviceLike, resolve_device
from debiasing_multi_modal_tpu_torch.utils.profiling import annotate, count, spanned
from debiasing_multi_modal_tpu_torch.utils.staging import DeviceCache, upload

Tree = Dict[str, torch.Tensor]
DRAW_WORKERS = 4  # threads that build the rows' classifiers


@torch.no_grad()
def _select_rows(base: Tree, update: Tree, mask: torch.Tensor) -> Tree:
    """Per-row masked snapshot: rows of ``update`` where ``mask [S]``, else
    ``base``, as fresh tensors on the device (no host round trip)."""
    return {k: torch.where(mask.view((-1,) + (1,) * (u.dim() - 1)), u, base[k]).detach()
            for k, u in update.items()}


def _take_rows(tree: Tree, rows: torch.Tensor) -> Tree:
    """A subset of the stacked rows."""
    return {k: v.index_select(0, rows) for k, v in tree.items()}


def _pad_stack_plans(plans):
    """Stack per-row BatchPlans of differing shapes into padded arrays:
    ``(idx [S, nb_max, bs_max], mask, active [S, nb_max])``.  Shorter epochs
    pad with index-0 batches under a False mask AND a False step-activity
    flag, so a padded step is a true no-op for its row (train/steps.py)."""
    S = len(plans)
    nb_max = max(p.indices.shape[0] for p in plans)
    bs_max = max(p.indices.shape[1] for p in plans)
    idx = np.zeros((S, nb_max, bs_max), np.int64)
    msk = np.zeros((S, nb_max, bs_max), bool)
    act = np.zeros((S, nb_max), bool)
    for i, p in enumerate(plans):
        nb, bs = p.indices.shape
        idx[i, :nb, :bs] = p.indices
        msk[i, :nb, :bs] = p.mask
        act[i, :nb] = True
    return idx, msk, act


def _sub(tree: Tree, prefix: str) -> Tree:
    return {k: v for k, v in tree.items() if k.startswith(prefix)}


def _row_results(c, bundle: DataBundle, weighted: bool) -> List[Dict[str, float]]:
    """Each row's metrics from host ``(corrects, counts)`` ``c``, group-weighted if ``weighted``."""
    return [results_from_counts(c[0][i], c[1][i], n_places=bundle.n_places,
                                train_group_ratio=bundle.train_group_ratio if weighted else None)
            for i in range(len(c[0]))]


class _Rows:
    """The stacked rows: each row's numpy Generator and CPU
    ``torch.Generator`` (both seeded with its seed) and config, the device,
    the host arrays staged to it, and the plans' batch slots and those that
    hold a sample (they go to the counters once the whole call has run, so a
    cut sweep adds none)."""

    def __init__(self, cfg: TrainConfig, cfgs: List[TrainConfig], seeds: Sequence[int],
                 bundle: DataBundle, dev: torch.device):
        self.cfg, self.cfgs, self.bundle, self.dev = cfg, cfgs, bundle, dev
        self.n = len(seeds)
        self.rngs = [np.random.default_rng(s) for s in seeds]
        self.gens = [torch.Generator().manual_seed(int(s)) for s in seeds]
        self.train_bs = [rc.batch_size for rc in cfgs]
        # eval batching is semantics-free (running BN stats, per-row logits,
        # exact group counts): the rows share the largest cell's
        self.eval_bs = max(rc.batch_size_reg if cfg.is_reg_method else rc.batch_size
                           for rc in cfgs)
        self.stage = DeviceCache(dev)
        self._groups: Dict[int, tuple] = {}
        self._eval_plans: Dict[Tuple[int, int], tuple] = {}
        self.contrastive = None  # each row's SupCon rows and the counts, at the first such epoch
        self.slots = [0, 0]

    def groups(self, split) -> torch.Tensor:
        """The split's int64 group ids on the device, uploaded once."""
        got = self._groups.get(id(split))
        if got is None or got[0] is not split:
            got = self._groups[id(split)] = (split, upload(split.group.astype(np.int64), self.dev))
        return got[1]

    def plans(self, split_len: int, bs: List[int], orders=None):
        """Each row's epoch plan over ``split_len`` samples at its batch size
        ``bs[i]``: in ``orders[i]``, or shuffled by the row's rng."""
        with annotate("sweep.plans"):
            return [epoch_plan(split_len, b, shuffle=o is None, rng=rng, order=o)
                    for b, o, rng in zip(bs, orders or [None] * self.n, self.rngs)]

    def lrs(self, epoch: int, nbs: List[int], phase: int) -> np.ndarray:
        """``[S, max(nbs)]`` rates, zero-padded: each row's schedule for an epoch of its
        ``nbs[i]`` batches (warmup indexed by its REAL batch count, as in its sequential run)."""
        out = np.zeros((self.n, max(nbs)), np.float32)
        memo = {}  # rows of one grid cell share (cfg, nb)
        for i, (rc, nb) in enumerate(zip(self.cfgs, nbs)):
            if (rc, nb) not in memo:
                memo[rc, nb] = epoch_batch_lrs(rc, epoch, nb, phase)
            out[i, :nb] = memo[rc, nb]
        return out

    def reg_orders(self, reg_split):
        """This epoch's per-row orders into the reg split (balanced subsets
        under ``balance_val``, else None: shuffles) and reg batch sizes."""
        with annotate("sweep.plans"):
            if reg_split is None:
                return None, None
            if self.cfg.balance_val:
                orders = [balanced_subset_indices(reg_split.group, rng, self.bundle.n_groups)
                          for rng in self.rngs]
                return orders, [min(rc.batch_size_reg, len(o)) for rc, o in zip(self.cfgs, orders)]
            return None, [rc.batch_size_reg for rc in self.cfgs]

    def train(self, st, split, labels, text, plans, epoch: int, phase: int, mask_tree):
        """One stacked train epoch of ``plans`` at phase ``phase``'s rates.  Plans of one
        shape stack; rows of different batch sizes pad to the longest epoch."""
        dev, cfg = self.dev, self.cfg
        with annotate("sweep.plans"):
            lrs = self.lrs(epoch, [p.num_batches for p in plans], phase)
            if len({p.indices.shape for p in plans}) == 1:
                idx = np.stack([p.indices for p in plans]).astype(np.int64)
                msk = np.stack([p.mask for p in plans])
                act = None
            else:
                idx, msk, act = _pad_stack_plans(plans)
            self.slots[0] += msk.size
            self.slots[1] += int(np.count_nonzero(msk))
            args = (st, split.emb, self.stage(labels), self.groups(split), upload(idx, dev),
                    upload(msk, dev), upload(lrs, dev), self.stage(text), mask_tree)
            active = None if act is None else upload(act, dev)
        with annotate("sweep.train"):
            return train_epoch_vmapped(*args, active=active, n_groups=self.bundle.n_groups,
                                       momentum=cfg.momentum, weight_decay=cfg.weight_decay)

    def evaluate(self, st, split, labels, text):
        with annotate("sweep.eval"):
            idx, msk = cached_eval_plan(self._eval_plans, split, self.eval_bs,
                                        lambda a: upload(a, self.dev))
            return eval_epoch_vmapped(st, split.emb, self.stage(labels), self.groups(split), idx,
                                      msk, self.stage(text), n_groups=self.bundle.n_groups)


class _Data:
    """The splits and label vectors the epochs read.  The reg methods split
    val in two stratified halves: the reg split and what stays val."""

    def __init__(self, cfg: TrainConfig, bundle: DataBundle):
        if cfg.is_reg_method:
            reg_idx, val_idx = stratified_split_indices(bundle.val.group, 0.5, seed=42)
            self.reg, self.val = bundle.val.take(reg_idx), bundle.val.take(val_idx)
        else:
            self.reg, self.val = None, bundle.val
        self.sample_weights = None if not cfg.resample_ce else resampled_ce_weights(
            bundle.train.y, bundle.train.y_pred, n_classes=cfg.n_cls, correct_class_bias=True,
            reweighting_by_class=False)
        self.train_labels = bundle.train.labels(cfg.train_target)
        if int(self.train_labels.max()) >= bundle.text_class.shape[1]:
            raise ValueError(f"train_target={cfg.train_target!r} yields labels up to "
                             f"{int(self.train_labels.max())} but the class text matrix has "
                             f"only {bundle.text_class.shape[1]} columns (see train/loop.py)")
        self.val_labels = self.val.labels(cfg.train_target)
        self.test_labels = bundle.test.labels("class")
        self.reg_target = self.reg_group = None
        if self.reg is None:
            return
        self.reg_target = self.reg.labels(cfg.train_target)
        self.reg_group = self.reg.group.astype(np.int32)
        if int(self.reg_group.max()) >= bundle.text_group.shape[1]:
            raise ValueError(f"group labels reach {int(self.reg_group.max())} but the group "
                             f"text matrix has only {bundle.text_group.shape[1]} columns")


class _Models:
    """The rows' stacked modules: the classifiers (``state``), the
    contrastive heads' params and trace (``head``), and from the stage
    switch on the MultipleAdapters (``multiple``, trained under
    ``ma_mask``).  A row's classifiers draw from its own generator alone, in
    the sequential loop's order, so worker threads build them (the draws
    release the GIL); the phase-2 ones are each generator's next draws."""

    def __init__(self, cfg: TrainConfig, rows: _Rows, inits: List[Mapping[str, Mapping]]):
        workers = ThreadPoolExecutor(max_workers=DRAW_WORKERS)
        singles = list(workers.map(lambda g: make_classifier(cfg, g), rows.gens))
        for module, init in zip(singles, inits):
            if "init_sd" in init:
                module.load_state_dict(_tensors(init["init_sd"]))
        self.temperature = cfg.zs_temperature
        self.state = StackedState.stack(singles, rows.dev, self.temperature)
        self.full_mask = ones_mask(self.state.params)
        self.head: Optional[StackedState] = None
        if cfg.tl_method == "contrastive_adapter" and cfg.ca_head is not None:
            encoders = [make_encoder(cfg, m.adapter, g) for m, g in zip(singles, rows.gens)]
            for enc, init in zip(encoders, inits):
                if "ca_head_sd" in init:
                    enc.head.load_state_dict(_tensors(init["ca_head_sd"], "head."))
            stacked = StackedState.stack([enc.head for enc in encoders], rows.dev)
            self.head = StackedState({f"head.{k}": v for k, v in stacked.params.items()}, {},
                                     {f"head.{k}": v for k, v in stacked.trace.items()})
        self.multiple, self.ma_mask = None, None
        self.pending = [workers.submit(make_multiple_classifier, cfg, g) for g in rows.gens] \
            if cfg.uses_multiple(cfg.epochs) else []
        workers.shutdown(wait=False)

    def current(self, multiple: bool) -> StackedState:
        return self.multiple if multiple else self.state


class _Best:
    """Each row's best epoch: worst-group accuracy, epoch and module kind on
    the host, snapshots on the device, one stacked pair per module kind (a
    row's best may predate the MultipleAdapter switch while another's
    postdates it).  Unselected rows hold stale values and are never read."""

    def __init__(self, n: int):
        self.acc, self.epoch, self.multiple = np.zeros(n), np.zeros(n, np.int64), np.zeros(n, bool)
        self.snaps: Dict[bool, Optional[Tuple[Tree, Tree]]] = {False: None, True: None}

    def _take(self, rows: np.ndarray, multiple: bool, cur: StackedState, dev) -> None:
        m = upload(rows, dev)
        base = self.snaps[multiple] or (cur.params, cur.buffers)
        self.snaps[multiple] = (_select_rows(base[0], cur.params, m),
                                _select_rows(base[1], cur.buffers, m))

    def update(self, worst: np.ndarray, epoch: int, multiple: bool, cur: StackedState, dev):
        """Snapshot the rows whose val worst-group accuracy improved."""
        improved = worst > self.acc
        if improved.any():
            self._take(improved, multiple, cur, dev)
            self.acc = np.where(improved, worst, self.acc)
            self.epoch = np.where(improved, epoch, self.epoch)
            self.multiple = np.where(improved, multiple, self.multiple)

    def fill_never_improved(self, multiple: bool, final: StackedState, epochs: int, dev):
        """Rows that never improved keep their final state (the sequential loop's fallback)."""
        never = self.epoch == 0
        if never.any():
            self._take(never, multiple, final, dev)
            self.multiple = np.where(never, multiple, self.multiple)
            self.epoch = np.where(never, epochs, self.epoch)


def _reg_epoch(rows: _Rows, data: _Data, models: _Models, epoch: int, reg):
    """adapter_reg: a train epoch on the class prompts, then one on the reg
    split (group prompts unless ``use_cls_prompt_in_reg``)."""
    b = rows.bundle
    plans = rows.plans(len(b.train), rows.train_bs)
    models.state, stats = rows.train(models.state, b.train, data.train_labels, b.text_class,
                                     plans, epoch, 1, models.full_mask)
    group_prompt = not rows.cfg.use_cls_prompt_in_reg
    rplans = rows.plans(len(data.reg), reg[1], orders=reg[0])
    models.state, reg_stats = rows.train(
        models.state, data.reg, data.reg_group if group_prompt else data.reg_target,
        b.text_group if group_prompt else b.text_class, rplans, epoch, 1, models.full_mask)
    return (stats if group_prompt else stats.merge(reg_stats)), False


def _switch_stage(rows: _Rows, models: _Models, best: _Best, inits) -> None:
    """Phase 2's first epoch.  Under ``continue_from_best`` rows with a best
    snapshot (all of phase 1's share one kind) load it.  With ``add_adapter``
    each row's MultipleAdapter takes its phase-1 adapter; else the
    classifier gets a fresh optimizer (momentum reset)."""
    cfg, t = rows.cfg, models.temperature
    if cfg.continue_from_best and (best.epoch > 0).any():
        has = upload(best.epoch > 0, rows.dev)
        bp, bb = best.snaps[False]
        models.state = StackedState.from_tensors(_select_rows(models.state.params, bp, has),
                                                 _select_rows(models.state.buffers, bb, has), t)
    if not cfg.add_adapter:
        models.state = StackedState.from_tensors(models.state.params, models.state.buffers, t)
        return
    multiples = [f.result() for f in models.pending]
    models.pending = []
    for m, init in zip(multiples, inits):
        if "ma_new_sd" in init and not cfg.init_near_identity:
            m.new_adapter.load_state_dict(_tensors(init["ma_new_sd"], "new_adapter."))
    ma = StackedState.stack(multiples, rows.dev, t)
    # the old branch (and, near identity, the new one) starts from each
    # row's phase-1 adapter
    targets = ("old_cls.adapter.", "new_adapter.") if cfg.init_near_identity \
        else ("old_cls.adapter.",)
    old = {**_sub(models.state.params, "adapter."), **_sub(models.state.buffers, "adapter.")}
    with torch.no_grad():
        for k, v in old.items():
            for prefix in targets:
                name = prefix + k[len("adapter."):]
                (ma.params if name in ma.params else ma.buffers)[name].copy_(v)
    models.multiple = StackedState.from_tensors(ma.params, ma.buffers, t)
    models.ma_mask = freeze_subtrees(models.multiple.params, ("old_cls",))


def _phase2_epoch(rows: _Rows, data: _Data, models: _Models, epoch: int, reg):
    """A sequential method past its feature epochs: the reg split alone, on
    the MultipleAdapter with ``add_adapter``, at phase 2's rates."""
    cfg, b = rows.cfg, rows.bundle
    use_group = cfg.use_group_prompt(epoch)
    labels = data.reg_group if use_group else data.reg_target
    text = b.text_group if use_group else b.text_class
    rplans = rows.plans(len(data.reg), reg[1], orders=reg[0])
    if cfg.add_adapter:
        models.multiple, stats = rows.train(models.multiple, data.reg, labels, text, rplans,
                                            epoch, 2, models.ma_mask)
    else:
        models.state, stats = rows.train(models.state, data.reg, labels, text, rplans, epoch, 2,
                                         models.full_mask)
    return stats, False


def _contrastive_epoch(rows: _Rows, data: _Data, models: _Models, epoch: int, reg):
    """The rows' SupCon epoch, then the interleaved CE pass (a whole epoch,
    or capped at ``ca_ce_update`` batches); pure SupCon takes its train
    metrics from the weighted zero-shot pass."""
    cfg, b, S, dev = rows.cfg, rows.bundle, rows.n, rows.dev
    # rows and reshuffles draw from each row's rng in the sequential loop's
    # order; the row counts depend only on the data, so the stack is regular
    with annotate("sweep.plans"):
        if rows.contrastive is None:
            rows.contrastive = contrastive_rows_and_counts(cfg, b, rows.rngs)
        ca_rows, ca_counts = rows.contrastive
        batches = np.stack([contrastive_epoch_rows(ca_rows[i], rows.rngs[i], cfg.batch_factor)
                            for i in range(S)])
        rows_dev = upload(batches, dev)
        lrs_dev = upload(rows.lrs(epoch, [batches.shape[1]] * S, 1), dev)
    state, head = models.state, models.head or StackedState({}, {}, {})
    enc = StackedState({**_sub(state.params, "adapter."), **head.params},
                       _sub(state.buffers, "adapter."),
                       {**_sub(state.trace, "adapter."), **head.trace})
    with annotate("sweep.train"):
        train_contrastive_epoch_vmapped(
            enc, b.train.emb, rows_dev, lrs_dev, ones_mask(enc.params), num_anchor=ca_counts[0],
            num_positive=ca_counts[1], num_negative=ca_counts[2], temperature=cfg.cl_temperature,
            contrastive_weight=cfg.contrastive_weight, ca_pre_norm=cfg.ca_pre_norm,
            momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    if cfg.ca_ce_update == 0:
        return rows.evaluate(state, b.train, data.train_labels, b.text_class), True
    ce_orders = [rng.permutation(len(b.train))[: cfg.ca_ce_update * bs]
                 for rng, bs in zip(rows.rngs, rows.train_bs)] if cfg.ca_ce_update > 0 else None
    plans = rows.plans(len(b.train), rows.train_bs, orders=ce_orders)
    models.state, stats = rows.train(state, b.train, data.train_labels, b.text_class, plans,
                                     epoch, 1, models.full_mask)
    return stats, False


def _erm_epoch(rows: _Rows, data: _Data, models: _Models, epoch: int, reg):
    """A train-split epoch (linear_probing, adapter, phase 1), in orders
    drawn from the resampled weights under ``resample_ce``."""
    b = rows.bundle
    w = data.sample_weights
    orders = None if w is None else [weighted_sample_indices(w, len(b.train), rng)
                                     for rng in rows.rngs]
    plans = rows.plans(len(b.train), rows.train_bs, orders=orders)
    models.state, stats = rows.train(models.state, b.train, data.train_labels, b.text_class,
                                     plans, epoch, 1, models.full_mask)
    return stats, False


# TrainConfig.epoch_kind -> epoch (its train meters, whether they are group-weighted)
_EPOCHS = {"reg": _reg_epoch, "phase2": _phase2_epoch, "contrastive": _contrastive_epoch,
           "erm": _erm_epoch}


def _probes(rows: _Rows, best: _Best, target: str) -> List[Dict[str, float]]:
    """Each row's zero-shot probe of the test split on ``target`` with its
    best model: one stacked evaluation per module kind."""
    cfg, b = rows.cfg, rows.bundle
    if cfg.tl_method == "linear_probing":
        return [zero_shot_results(b, target, cfg.zs_temperature)] * rows.n
    text = b.text_class if target == "class" else b.text_spurious
    labels = b.test.labels(target)
    out: List[Optional[Dict[str, float]]] = [None] * rows.n
    for kind in (False, True):
        ids = [i for i in range(rows.n) if bool(best.multiple[i]) == kind]
        if not ids:
            continue
        ridx = upload(np.asarray(ids, np.int64), rows.dev)
        sub = StackedState(*(_take_rows(t, ridx) for t in best.snaps[kind]), {},
                           cfg.zs_temperature)
        stats = rows.evaluate(sub, b.test, labels, text)
        c = torch.stack([stats.corrects, stats.counts]).cpu().numpy()
        for i, res in zip(ids, _row_results(c, b, True)):
            out[i] = res
    return out


@spanned("sweep.run")
def train_seeds_vmapped(
    cfg: TrainConfig,
    bundle: DataBundle,
    seeds: Sequence[int],
    verbose: bool = False,
    mesh=None,
    lr_grid: Optional[Sequence[Tuple[float, float]]] = None,
    cell_grid: Optional[Sequence[TrainConfig]] = None,
    inits: Optional[Sequence[Mapping[str, Mapping]]] = None,
    device: DeviceLike = None,
):
    """Train all rows at once on ``device`` (``cuda`` unless the caller asks
    for the CPU); returns a list (per row) of the
    ``((best_train, best_val, best_test), (zs_class, zs_spurious))`` tuples
    the sequential loop produces.

    ``lr_grid`` stacks a learning-rate grid axis: rows become (lr cell x
    seed) pairs, cells outer, each row under its own schedule.
    ``cell_grid`` generalizes it to whole per-cell configs that may also
    differ in ``batch_size_reg`` and ``batch_size``: epoch plans pad to the
    longest row's (num_batches, batch_size) and shorter rows no-op through
    their padded tail, so the whole (lr x bsr x bs) grid trains as one
    program.  Cells must agree with ``cfg`` in everything but
    learning_rate, learning_rate_reg, batch_size_reg and batch_size.
    Without either, ``cfg`` is the one cell.

    ``inits`` (one per row, in ``train_all_epochs``'s ``init`` layout) gives
    the rows' initial weights; without it each row draws from a CPU
    ``torch.Generator`` seeded with its seed, in the sequential loop's
    order.

    ``mesh`` (whose axes include ``data``) shards the rows over the data
    axis: the row count (grid cells x seeds) must divide by its size; each
    rank trains its contiguous rows, and every rank returns every row's
    results in row order.  A bundle from ``train/loop.shard_bundle`` is
    gathered whole first (the rows, not the data, are what is sharded).
    """
    if cell_grid is not None and lr_grid is not None:
        raise ValueError("pass either lr_grid or cell_grid, not both")
    if lr_grid is not None:
        cell_grid = [cfg.replace(learning_rate=float(lr), learning_rate_reg=float(lrr))
                     for (lr, lrr) in lr_grid]
    cells = [cfg] if cell_grid is None else list(cell_grid)
    for rc in cells:
        if rc.replace(learning_rate=cfg.learning_rate, learning_rate_reg=cfg.learning_rate_reg,
                      batch_size_reg=cfg.batch_size_reg, batch_size=cfg.batch_size) != cfg:
            raise ValueError(
                "cell_grid cells may differ from the base config only in "
                "learning_rate / learning_rate_reg / batch_size_reg / batch_size")
    row_cfgs = [rc for rc in cells for _ in seeds]
    seeds = [s for _ in cells for s in seeds]
    S = len(seeds)
    if inits is not None and len(inits) != S:
        raise ValueError(f"inits has {len(inits)} entries for {S} rows")
    inits = list(inits) if inits is not None else [{}] * S
    data_group = None
    if mesh is not None:
        n_data = axis_size(mesh, "data")
        if S % n_data:
            what = f"len(seeds)={S}" if cell_grid is None else f"rows (grid cells x seeds) = {S}"
            raise ValueError(f"{what} must be divisible by the mesh data axis size ({n_data})")
        data_group = axis_group(mesh, "data")
        S //= n_data
        mine = slice(axis_rank(mesh, "data") * S, (axis_rank(mesh, "data") + 1) * S)
        seeds, inits, row_cfgs = seeds[mine], inits[mine], row_cfgs[mine]
    dev = resolve_device(device)
    bundle = move_bundle(gather_bundle(bundle), dev)
    rows = _Rows(cfg, row_cfgs, seeds, bundle, dev)
    data = _Data(cfg, bundle)
    models = _Models(cfg, rows, inits)
    best = _Best(S)
    history = []  # per epoch: the rows' (train, val, test) results

    for epoch in range(1, cfg.epochs + 1):
        with annotate("sweep.epoch"):
            reg = rows.reg_orders(data.reg)
            kind = cfg.epoch_kind(epoch)
            if kind == "phase2" and epoch == cfg.feature_epochs + 1:
                _switch_stage(rows, models, best, inits)
            stats, train_weighted = _EPOCHS[kind](rows, data, models, epoch, reg)
            multiple = cfg.uses_multiple(epoch)
            cur = models.current(multiple)
            val_stats = rows.evaluate(cur, data.val, data.val_labels, bundle.text_class)
            test_stats = rows.evaluate(cur, bundle.test, data.test_labels, bundle.text_class)
            # ONE host read for the epoch's train/val/test meters of every row
            with annotate("sweep.read"):
                counts = torch.stack([torch.stack([s.corrects, s.counts])
                                      for s in (stats, val_stats, test_stats)]).cpu().numpy()
            with annotate("sweep.select"):
                res = [_row_results(c, bundle, w)
                       for c, w in zip(counts, (train_weighted, True, True))]
                history.append([[ordered(r) for r in part] for part in res])
                if verbose:
                    print(f"epoch {epoch}: val worst", [round(v["worst_acc"], 4) for v in res[1]])
                best.update(np.asarray([v["worst_acc"] for v in res[1]]), epoch, multiple, cur,
                            dev)

    # final zero-shot probes with each row's best model
    multiple = cfg.uses_multiple(cfg.epochs)
    best.fill_never_improved(multiple, models.current(multiple), cfg.epochs, dev)
    zs_class, zs_spurious = _probes(rows, best, "class"), _probes(rows, best, "spurious")
    results = [(tuple(part[i] for part in history[int(best.epoch[i]) - 1]),
                (ordered(zs_class[i]), ordered(zs_spurious[i]))) for i in range(S)]
    count("sweep.slots", rows.slots[0])
    count("sweep.useful_slots", rows.slots[1])
    if data_group is None:
        return results
    parts = [None] * dist.get_world_size(data_group)
    dist.all_gather_object(parts, results, group=data_group)
    return [row for part in parts for row in part]
