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
layout.  Best-model snapshots stay on the device (:func:`_select_rows`); the
host reads each epoch's meters once, for every row together.

With a ``mesh`` the rows are sharded over its ``data`` axis, as the JAX
sweep shards its seed axis: each rank trains its contiguous rows as one
stacked program, and every row's results are gathered in row order.
"""

from __future__ import annotations

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
    if cell_grid is not None:
        for rc in cell_grid:
            if rc.replace(learning_rate=cfg.learning_rate,
                          learning_rate_reg=cfg.learning_rate_reg,
                          batch_size_reg=cfg.batch_size_reg,
                          batch_size=cfg.batch_size) != cfg:
                raise ValueError(
                    "cell_grid cells may differ from the base config only in "
                    "learning_rate / learning_rate_reg / batch_size_reg / batch_size")
        row_cfgs = [rc for rc in cell_grid for _ in seeds]
        seeds = [s for _ in cell_grid for s in seeds]
    else:
        row_cfgs = None
    S = len(seeds)
    if inits is not None and len(inits) != S:
        raise ValueError(f"inits has {len(inits)} entries for {S} rows")
    inits = list(inits) if inits is not None else [{}] * S
    # eval batching is semantics-free (running BN stats, per-row logits,
    # exact group counts): grid-stacked rows share the largest cell's
    eval_bs = (
        (max(rc.batch_size_reg for rc in row_cfgs) if row_cfgs is not None
         else cfg.batch_size_reg)
        if cfg.is_reg_method
        else (max(rc.batch_size for rc in row_cfgs) if row_cfgs is not None
              else cfg.batch_size)
    )
    data_group = None
    if mesh is not None:
        n_data = axis_size(mesh, "data")
        if S % n_data:
            what = (f"rows (grid cells x seeds) = {S}" if row_cfgs is not None
                    else f"len(seeds)={S}")
            raise ValueError(f"{what} must be divisible by the mesh data axis size ({n_data})")
        data_group = axis_group(mesh, "data")
        S //= n_data
        mine = slice(axis_rank(mesh, "data") * S, (axis_rank(mesh, "data") + 1) * S)
        seeds, inits = seeds[mine], inits[mine]
        row_cfgs = row_cfgs[mine] if row_cfgs is not None else None
    dev = resolve_device(device)
    bundle = move_bundle(gather_bundle(bundle), dev)
    rngs = [np.random.default_rng(s) for s in seeds]
    gens = [torch.Generator().manual_seed(int(s)) for s in seeds]

    def batch_lrs(epoch, nb, phase):
        """[nb] shared schedule, or [S, nb] per row when grid-stacked."""
        if row_cfgs is None:
            return epoch_batch_lrs(cfg, epoch, nb, phase)
        return np.stack([epoch_batch_lrs(rc, epoch, nb, phase) for rc in row_cfgs])

    def batch_lrs_plans(epoch, plans, phase):
        """Per-plan schedules: [nb] shared, or [S, nb_max] zero-padded when
        rows have their own configs or epoch lengths (warmup is indexed by
        the row's REAL batch count, matching its sequential run)."""
        with annotate("sweep.plans"):
            nbs = [p.num_batches for p in plans]
            if row_cfgs is None and len(set(nbs)) == 1:
                return epoch_batch_lrs(cfg, epoch, nbs[0], phase)
            out = np.zeros((S, max(nbs)), np.float32)
            memo = {}  # rows of one grid cell share (cfg, nb)
            for i in range(S):
                rc = row_cfgs[i] if row_cfgs is not None else cfg
                row = memo.get((rc, nbs[i]))
                if row is None:
                    row = memo[(rc, nbs[i])] = epoch_batch_lrs(rc, epoch, nbs[i], phase)
                out[i, : nbs[i]] = row
            return out

    if cfg.is_reg_method:
        reg_idx, val_idx = stratified_split_indices(bundle.val.group, 0.5, seed=42)
        reg_split = bundle.val.take(reg_idx)
        val_split = bundle.val.take(val_idx)
    else:
        reg_split, val_split = None, bundle.val
    # the train batch size per row when bs-stacked (a list gives per-row plans)
    train_bs = [rc.batch_size for rc in row_cfgs] if row_cfgs is not None else cfg.batch_size

    sample_weights = None
    if cfg.resample_ce:
        sample_weights = resampled_ce_weights(
            bundle.train.y, bundle.train.y_pred, n_classes=cfg.n_cls,
            correct_class_bias=True, reweighting_by_class=False,
        )

    # ----- initial weights, each row's draws in the sequential loop's order
    singles = [make_classifier(cfg, g) for g in gens]
    for module, init in zip(singles, inits):
        if "init_sd" in init:
            module.load_state_dict(_tensors(init["init_sd"]))
    temperature = cfg.zs_temperature
    state = StackedState.stack(singles, dev, temperature)
    full_mask = ones_mask(state.params)

    head: Optional[StackedState] = None  # the contrastive heads' params and trace
    if cfg.tl_method == "contrastive_adapter" and cfg.ca_head is not None:
        encoders = [make_encoder(cfg, m.adapter, g) for m, g in zip(singles, gens)]
        for enc, init in zip(encoders, inits):
            if "ca_head_sd" in init:
                enc.head.load_state_dict(_tensors(init["ca_head_sd"], "head."))
        stacked = StackedState.stack([enc.head for enc in encoders], dev)
        head = StackedState({f"head.{k}": v for k, v in stacked.params.items()}, {},
                            {f"head.{k}": v for k, v in stacked.trace.items()})
    del singles

    ma_state: Optional[StackedState] = None
    ma_mask = None

    train_labels = bundle.train.labels(cfg.train_target)
    if int(train_labels.max()) >= bundle.text_class.shape[1]:
        raise ValueError(
            f"train_target={cfg.train_target!r} yields labels up to "
            f"{int(train_labels.max())} but the class text matrix has only "
            f"{bundle.text_class.shape[1]} columns (see train/loop.py)")
    val_labels = val_split.labels(cfg.train_target)
    test_labels_cls = bundle.test.labels("class")
    reg_labels_target = reg_split.labels(cfg.train_target) if reg_split is not None else None
    reg_labels_group = reg_split.group.astype(np.int32) if reg_split is not None else None
    if reg_labels_group is not None and int(reg_labels_group.max()) >= bundle.text_group.shape[1]:
        raise ValueError(
            f"group labels reach {int(reg_labels_group.max())} but the group "
            f"text matrix has only {bundle.text_group.shape[1]} columns")

    text_class, text_group = bundle.text_class, bundle.text_group
    feat_epochs = (cfg.epochs if cfg.epochs_feature_learning is None
                   else cfg.epochs_feature_learning)  # 0: stage 2 from epoch 1

    # Per-row best bookkeeping: scalars on the host, snapshots on the device,
    # one stacked pair per module kind (a row's best may predate the
    # MultipleAdapter switch while another's postdates it).  Unselected rows
    # hold stale values and are never read.
    best = {"acc": np.zeros(S), "epoch": np.zeros(S, np.int64),
            "multiple": np.zeros(S, bool)}
    dev_best: Dict[bool, Optional[Tuple[Tree, Tree]]] = {False: None, True: None}
    contrastive_rows, ca_counts = None, None
    history = {"train": [[] for _ in range(S)], "val": [[] for _ in range(S)],
               "test": [[] for _ in range(S)]}

    # Host arrays that recur every epoch (labels, int64 groups, text
    # matrices, eval plans) are staged to the device once.
    stage = DeviceCache(dev)
    groups64: Dict[int, tuple] = {}
    eval_plans: Dict[Tuple[int, int], tuple] = {}

    def grp(split):
        got = groups64.get(id(split))
        if got is None or got[0] is not split:
            got = groups64[id(split)] = (split, upload(split.group.astype(np.int64), dev))
        return got[1]

    # the stacked plans' batch slots and those that hold a sample; they go
    # to the counters once the whole call has run, so a cut sweep adds none
    slots = [0, 0]

    def vm_train(st, split, labels, text, plans, lrs, mask_tree):
        with annotate("sweep.plans"):
            if len({p.indices.shape for p in plans}) == 1:
                idx = np.stack([p.indices for p in plans]).astype(np.int64)
                msk = np.stack([p.mask for p in plans])
                act = None
            else:  # rows of different batch sizes: pad to the longest epoch
                idx, msk, act = _pad_stack_plans(plans)
            slots[0] += msk.size
            slots[1] += int(np.count_nonzero(msk))
            args = (st, split.emb, stage(labels), grp(split), upload(idx, dev),
                    upload(msk, dev), upload(np.asarray(lrs, np.float32), dev), stage(text),
                    mask_tree)
            active = None if act is None else upload(act, dev)
        with annotate("sweep.train"):
            return train_epoch_vmapped(*args, active=active, n_groups=bundle.n_groups,
                                       momentum=cfg.momentum, weight_decay=cfg.weight_decay)

    def vm_eval(st, split, labels, text):
        with annotate("sweep.eval"):
            idx, msk = cached_eval_plan(eval_plans, split, eval_bs, lambda a: upload(a, dev))
            return eval_epoch_vmapped(st, split.emb, stage(labels), grp(split), idx, msk,
                                      stage(text), n_groups=bundle.n_groups)

    def make_plans(split_len, bs, orders=None, shuffle=True):
        """``bs`` is shared (int) or per-row (list) for grid-stacked rows."""
        with annotate("sweep.plans"):
            plans = []
            for i in range(S):
                order = None if orders is None else orders[i]
                bs_i = bs[i] if isinstance(bs, list) else bs
                plans.append(epoch_plan(split_len, bs_i, shuffle=shuffle and order is None,
                                        rng=rngs[i], order=order))
            return plans

    for epoch in range(1, cfg.epochs + 1):
        with annotate("sweep.epoch"):
            # per-row balanced reg orders; per-row reg batch size when stacked
            with annotate("sweep.plans"):
                if cfg.balance_val and cfg.is_reg_method:
                    reg_orders = [balanced_subset_indices(reg_split.group, rngs[i], bundle.n_groups)
                                  for i in range(S)]
                    reg_bs = [min((row_cfgs[i] if row_cfgs is not None else cfg).batch_size_reg,
                                  len(reg_orders[i])) for i in range(S)]
                elif reg_split is not None:
                    reg_orders = None
                    reg_bs = [(row_cfgs[i] if row_cfgs is not None else cfg).batch_size_reg
                              for i in range(S)]

            train_weighted = False
            if cfg.tl_method == "adapter_reg":
                plans = make_plans(len(bundle.train), train_bs)
                state, stats = vm_train(state, bundle.train, train_labels, text_class, plans,
                                        batch_lrs_plans(epoch, plans, 1), full_mask)
                group_prompt = not cfg.use_cls_prompt_in_reg
                rplans = make_plans(len(reg_split), reg_bs, orders=reg_orders)
                state, reg_stats = vm_train(
                    state, reg_split, reg_labels_group if group_prompt else reg_labels_target,
                    text_group if group_prompt else text_class, rplans,
                    batch_lrs_plans(epoch, rplans, 1), full_mask)
                if not group_prompt:
                    stats = stats.merge(reg_stats)
            elif cfg.is_two_phase and epoch > feat_epochs:
                if epoch == feat_epochs + 1:
                    if cfg.continue_from_best and (best["epoch"] > 0).any():
                        # rows with a best snapshot load it; the rest keep their
                        # phase-1 state (all phase-1 snapshots share one kind)
                        has = upload(best["epoch"] > 0, dev)
                        bp, bb = dev_best[False]
                        state = StackedState.from_tensors(_select_rows(state.params, bp, has),
                                                          _select_rows(state.buffers, bb, has),
                                                          temperature)
                    if cfg.add_adapter:
                        multiples = [make_multiple_classifier(cfg, g) for g in gens]
                        for m, init in zip(multiples, inits):
                            if "ma_new_sd" in init and not cfg.init_near_identity:
                                m.new_adapter.load_state_dict(
                                    _tensors(init["ma_new_sd"], "new_adapter."))
                        ma = StackedState.stack(multiples, dev, temperature)
                        del multiples
                        # the old branch (and, near identity, the new one) starts
                        # from each row's phase-1 adapter
                        targets = ("old_cls.adapter.", "new_adapter.") if cfg.init_near_identity \
                            else ("old_cls.adapter.",)
                        old = {**_sub(state.params, "adapter."), **_sub(state.buffers, "adapter.")}
                        with torch.no_grad():
                            for k, v in old.items():
                                for prefix in targets:
                                    name = prefix + k[len("adapter."):]
                                    (ma.params if name in ma.params else ma.buffers)[name].copy_(v)
                        ma_state = StackedState.from_tensors(ma.params, ma.buffers, temperature)
                        ma_mask = freeze_subtrees(ma_state.params, ("old_cls",))
                    else:
                        # a fresh optimizer on the same parameters (momentum reset)
                        state = StackedState.from_tensors(state.params, state.buffers, temperature)

                use_group = cfg.use_group_prompt(epoch)
                labels2 = reg_labels_group if use_group else reg_labels_target
                text2 = text_group if use_group else text_class
                rplans = make_plans(len(reg_split), reg_bs, orders=reg_orders)
                rlrs = batch_lrs_plans(epoch, rplans, 2)
                if cfg.add_adapter:
                    ma_state, stats = vm_train(ma_state, reg_split, labels2, text2, rplans, rlrs,
                                               ma_mask)
                else:
                    state, stats = vm_train(state, reg_split, labels2, text2, rplans, rlrs,
                                            full_mask)
            elif cfg.tl_method == "contrastive_adapter":
                # the rows' SupCon epochs: row construction and reshuffles draw
                # from each row's rng in the sequential loop's order; the row
                # counts depend only on the data, so the stack is regular
                with annotate("sweep.plans"):
                    if contrastive_rows is None:
                        contrastive_rows, ca_counts = contrastive_rows_and_counts(cfg, bundle, rngs)
                    rows = np.stack([contrastive_epoch_rows(contrastive_rows[i], rngs[i],
                                                            cfg.batch_factor) for i in range(S)])
                    rows_dev = upload(rows, dev)
                    lrs_dev = upload(np.asarray(batch_lrs(epoch, rows.shape[1], 1), np.float32),
                                     dev)
                enc = StackedState(
                    {**_sub(state.params, "adapter."), **(head.params if head else {})},
                    _sub(state.buffers, "adapter."),
                    {**_sub(state.trace, "adapter."), **(head.trace if head else {})})
                with annotate("sweep.train"):
                    train_contrastive_epoch_vmapped(
                        enc, bundle.train.emb, rows_dev, lrs_dev,
                        ones_mask(enc.params), num_anchor=ca_counts[0], num_positive=ca_counts[1],
                        num_negative=ca_counts[2], temperature=cfg.cl_temperature,
                        contrastive_weight=cfg.contrastive_weight, ca_pre_norm=cfg.ca_pre_norm,
                        momentum=cfg.momentum, weight_decay=cfg.weight_decay,
                    )
                if cfg.ca_ce_update != 0:
                    # the interleaved CE pass (a whole epoch, or capped at
                    # ca_ce_update batches), each row's rng in the loop's order
                    ce_orders = None
                    if cfg.ca_ce_update > 0:
                        ce_orders = [
                            rngs[i].permutation(len(bundle.train))[
                                : cfg.ca_ce_update
                                * (train_bs[i] if isinstance(train_bs, list) else train_bs)]
                            for i in range(S)]
                    plans = make_plans(len(bundle.train), train_bs, orders=ce_orders)
                    state, stats = vm_train(state, bundle.train, train_labels, text_class, plans,
                                            batch_lrs_plans(epoch, plans, 1), full_mask)
                else:
                    # pure SupCon: train metrics from the weighted zero-shot pass
                    stats = vm_eval(state, bundle.train, train_labels, text_class)
                    train_weighted = True
            else:
                orders = None
                if sample_weights is not None:
                    orders = [weighted_sample_indices(sample_weights, len(bundle.train), rngs[i])
                              for i in range(S)]
                plans = make_plans(len(bundle.train), train_bs, orders=orders)
                state, stats = vm_train(state, bundle.train, train_labels, text_class, plans,
                                        batch_lrs_plans(epoch, plans, 1), full_mask)

            in_ma = cfg.add_adapter and cfg.is_two_phase and epoch > feat_epochs
            cur = ma_state if in_ma else state
            val_stats = vm_eval(cur, val_split, val_labels, text_class)
            test_stats = vm_eval(cur, bundle.test, test_labels_cls, text_class)
            # ONE host read for the epoch's train/val/test meters of every row
            with annotate("sweep.read"):
                counts = torch.stack([torch.stack([s.corrects, s.counts])
                                      for s in (stats, val_stats, test_stats)]).cpu().numpy()

            def _res(c, weighted):
                return [results_from_counts(c[0][i], c[1][i], n_places=bundle.n_places,
                                            train_group_ratio=(bundle.train_group_ratio
                                                               if weighted else None))
                        for i in range(S)]

            with annotate("sweep.select"):
                train_res = _res(counts[0], train_weighted)
                val_res = _res(counts[1], True)
                test_res = _res(counts[2], True)
                for i in range(S):
                    history["train"][i].append(ordered(train_res[i]))
                    history["val"][i].append(ordered(val_res[i]))
                    history["test"][i].append(ordered(test_res[i]))
                if verbose:
                    print(f"epoch {epoch}: val worst", [round(v["worst_acc"], 4) for v in val_res])

                worst = np.asarray([v["worst_acc"] for v in val_res])
                improved = worst > best["acc"]
                if improved.any():
                    m = upload(improved, dev)
                    base = dev_best[in_ma] or (cur.params, cur.buffers)
                    dev_best[in_ma] = (_select_rows(base[0], cur.params, m),
                                       _select_rows(base[1], cur.buffers, m))
                    best["acc"] = np.where(improved, worst, best["acc"])
                    best["epoch"] = np.where(improved, epoch, best["epoch"])
                    best["multiple"] = np.where(improved, in_ma, best["multiple"])

    # -------- final zero-shot probes with each row's best model; rows that
    # never improved keep their final state (the sequential loop's fallback)
    final_in_ma = cfg.add_adapter and cfg.is_two_phase and cfg.epochs > feat_epochs
    final_state = ma_state if final_in_ma else state
    never = best["epoch"] == 0
    if never.any():
        m = upload(never, dev)
        base = dev_best[final_in_ma] or (final_state.params, final_state.buffers)
        dev_best[final_in_ma] = (_select_rows(base[0], final_state.params, m),
                                 _select_rows(base[1], final_state.buffers, m))
        best["multiple"] = np.where(never, final_in_ma, best["multiple"])
        best["epoch"] = np.where(never, cfg.epochs, best["epoch"])

    def zs(target):
        text = bundle.text_class if target == "class" else bundle.text_spurious
        labels = bundle.test.labels(target)
        if cfg.tl_method == "linear_probing":
            return [zero_shot_results(bundle, target, cfg.zs_temperature)] * S
        # one stacked evaluation per module kind
        out: List[Optional[Dict[str, float]]] = [None] * S
        for kind in (False, True):
            rows = [i for i in range(S) if bool(best["multiple"][i]) == kind]
            if not rows:
                continue
            ridx = upload(np.asarray(rows, np.int64), dev)
            sub = StackedState(_take_rows(dev_best[kind][0], ridx),
                               _take_rows(dev_best[kind][1], ridx), {}, temperature)
            stats = vm_eval(sub, bundle.test, labels, text)
            c = torch.stack([stats.corrects, stats.counts]).cpu().numpy()
            for j, i in enumerate(rows):
                out[i] = results_from_counts(c[0][j], c[1][j], n_places=bundle.n_places,
                                             train_group_ratio=bundle.train_group_ratio)
        return out

    zs_class = zs("class")
    zs_spurious = zs("spurious")
    results = []
    for i in range(S):
        be = int(best["epoch"][i])  # never-improved rows were set to cfg.epochs above
        results.append(((history["train"][i][be - 1], history["val"][i][be - 1],
                         history["test"][i][be - 1]),
                        (ordered(zs_class[i]), ordered(zs_spurious[i]))))
    count("sweep.slots", slots[0])
    count("sweep.useful_slots", slots[1])
    if data_group is None:
        return results
    parts = [None] * dist.get_world_size(data_group)
    dist.all_gather_object(parts, results, group=data_group)
    return [row for part in parts for row in part]
