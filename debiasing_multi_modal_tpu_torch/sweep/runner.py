"""Grid x seed sweep runner with mean±std aggregation (port of
``sweep/runner.py``).

Parity surface: reference ``run_multiple/final_main_iteration_wb.py`` (multi-
seed loop + pandas aggregation, :1129-1202) and ``..._iteration_ca.py``
(lr x bs x bsr grid wrapping the seed loop, :1179-1256, with
``learning_rate_reg = lr * lr_multiple``): per-cell CSVs named
``ds_{dataset}_tl_{method}_bs_{bs}_lr_{lr}[...].csv`` whose rows are
per-seed results plus mean/std rows, concatenating the test / zs-spurious /
train / val / zs-target blocks.

Execution is either the stacked simultaneous-row program (default,
sweep/vmap_loop.py) or the sequential loop (debug/verification), on
``device`` (``cuda`` unless the caller asks for the CPU).  ``mesh`` shards
the stacked rows over its ``data`` axis (``train_seeds_vmapped``); every
rank trains its rows, and rank 0 writes each CSV once.  The CSVs are
byte-identical to the JAX package's for the same result dicts."""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

import torch.distributed as dist

from debiasing_multi_modal_tpu_torch.parallel.mesh import axis_group, axis_size
from debiasing_multi_modal_tpu_torch.sweep.vmap_loop import train_seeds_vmapped
from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
from debiasing_multi_modal_tpu_torch.train.loop import DataBundle, train_all_epochs
from debiasing_multi_modal_tpu_torch.utils.platform import DeviceLike


def run_seeds(
    cfg: TrainConfig,
    bundle: DataBundle,
    seeds: Sequence[int],
    use_vmap: bool = True,
    verbose: bool = False,
    mesh=None,
    device: DeviceLike = None,
):
    """Per-seed result tuples ((train, val, test), (zs_class, zs_spurious)).

    ``mesh`` (stacked path only) shards the seed axis over its ``data``
    axis; see ``train_seeds_vmapped``."""
    if use_vmap:
        return train_seeds_vmapped(cfg, bundle, seeds, verbose=verbose, mesh=mesh,
                                   device=device)
    out = []
    for seed in seeds:
        res = train_all_epochs(cfg.replace(random_seed=seed), bundle, verbose=verbose,
                               device=device)
        out.append((res[0], res[1]))
    return out


def _block(rows: List[Dict[str, float]], label: str) -> List[Tuple[str, Dict[str, float]]]:
    keys = sorted({k for r in rows for k in r})
    mat = np.asarray([[r.get(k, np.nan) for k in keys] for r in rows], np.float64)
    out = [(str(i + 1), dict(zip(keys, mat[i]))) for i in range(len(rows))]
    out.append((f"{label}_mean", dict(zip(keys, np.nanmean(mat, axis=0)))))
    # The reference appends the mean row BEFORE calling pandas .std()
    # (final_main_iteration_wb.py:1149-1155), and std([x_1..x_n, mean],
    # ddof=1) == std(x, ddof=0) — so every published +-std (BASELINE.md,
    # e.g. wga 0.8625 +- 0.0160) is the population std of the seed rows.
    # Golden-pinned in tests/test_reference_log_parity.py.
    std = np.nanstd(mat, axis=0, ddof=0) if len(rows) > 1 else np.zeros(len(keys))
    out.append((f"{label}_std", dict(zip(keys, std))))
    return out


def aggregate_csv(results, path: str):
    """Write the reference's concatenated result CSV for one sweep cell."""
    tr = [r[0][0] for r in results]
    va = [r[0][1] for r in results]
    te = [r[0][2] for r in results]
    zs_t = [r[1][0] for r in results]
    zs_s = [r[1][1] for r in results]
    blocks = (
        _block(te, "test")
        + _block(zs_s, "zs_spu")
        + _block(tr, "tr")
        + _block(va, "val")
        + _block(zs_t, "zs_tg")
    )
    keys = sorted({k for _, row in blocks for k in row})
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("," + ",".join(keys) + "\n")
        for name, row in blocks:
            vals = ",".join(
                "" if k not in row or np.isnan(row[k]) else f"{round(row[k], 4)}"
                for k in keys
            )
            f.write(f"{name},{vals}\n")


def cell_filename(cfg: TrainConfig) -> str:
    """Reference CSV naming (final_main_iteration_wb.py:1162-1199)."""
    name = f"ds_{cfg.dataset}_tl_{cfg.tl_method}_bs_{cfg.batch_size}_lr_{cfg.learning_rate}"
    if "reg" in cfg.tl_method:
        name += f"_lrr{cfg.learning_rate_reg}_bsr{cfg.batch_size_reg}"
        if cfg.balance_val:
            name += "_balval"
        if cfg.tl_method != "adapter_reg_seq_alter":
            name += "_CP" if cfg.use_cls_prompt_in_reg else "_GP"
        if cfg.add_adapter:
            name += "_MA" + ("+ni" if cfg.init_near_identity else "+rn")
        if cfg.continue_from_best and "seq" in cfg.tl_method:
            name += "_cont"
    if cfg.resample_ce:
        name += "_rs"
    return name + ".csv"


def run_sweep(
    base_cfg: TrainConfig,
    bundle: DataBundle,
    seeds: Sequence[int],
    lr_list: Iterable[float] = (None,),
    bs_list: Iterable[int] = (None,),
    bsr_list: Iterable[int] = (None,),
    lr_multiple: Optional[float] = None,
    result_root: str = "results_iterative",
    use_vmap: bool = True,
    verbose: bool = False,
    mesh=None,
    stack_lr_axis: bool = False,
    stack_bsr_axis: bool = False,
    stack_bs_axis: bool = False,
    skip_existing: bool = False,
    device: DeviceLike = None,
) -> Dict[str, list]:
    """Nested lr x bs x bsr grid, each cell trained over all seeds.

    ``skip_existing`` makes a re-run resume a crashed/interrupted grid:
    cells whose CSV already exists under ``result_root`` are skipped (the
    reference loses a whole sweep's results to one crash — its logs record
    a lost CSV reconstructed from stdout, SURVEY §5.3; here each cell
    persists on completion and the grid is idempotent).

    ``stack_lr_axis`` collapses the lr loop into the stacked program: cells
    that differ only in learning rate share every tensor shape, so all of
    them train as extra stacked rows of ONE program
    (train_seeds_vmapped ``lr_grid``) instead of the reference's outer
    Python loop (final_main_iteration_ca.py:1179-1256): one set of launches
    per step for all |lr_list| cells.

    ``stack_bsr_axis`` additionally collapses the bsr loop (reg methods
    only): reg-epoch plans pad to the largest cell's shape and shorter rows
    no-op through the tail (train_seeds_vmapped ``cell_grid``), so the
    whole (lr x bsr) grid at one train batch size is ONE program — e.g. the
    reference's 16-cell Waterbirds grid (run_final_main_iteration_wb.sh:
    22-24) becomes two programs, one per bs.

    ``stack_bs_axis`` collapses the last loop: train-epoch plans pad
    per-row exactly like reg plans, so the ENTIRE grid — every
    (lr x bsr x bs) cell x every seed — is ONE stacked program.  It
    requires the inner axes to be stacked or trivial (lr stacked or
    singleton; bsr stacked, singleton, or inert because the method has no
    reg phase — inert bsr cells stack as duplicate rows).

    ``mesh`` shards each stacked program's rows over its ``data`` axis; a
    grid whose rows do not divide it is padded with copies of its last
    cell, whose rows are dropped.  Rank 0 writes the CSVs."""
    group = None if mesh is None else axis_group(mesh, "data")

    def write(results, path):
        """One CSV, written once; every rank waits until it is on disk."""
        if group is None or dist.get_rank() == 0:
            aggregate_csv(results, path)
        if group is not None:
            dist.barrier(group=group)

    def _cell_cfg(cfg, lr):
        if lr is None:
            return cfg
        cfg = cfg.replace(learning_rate=lr)
        if lr_multiple is not None:
            cfg = cfg.replace(learning_rate_reg=lr * lr_multiple)
        return cfg

    lr_values = list(lr_list)
    bsr_values = list(bsr_list)
    stack = (
        stack_lr_axis
        and use_vmap
        and len(lr_values) > 1
        and all(lr is not None for lr in lr_values)
    )
    # bsr stacking only differentiates reg methods (bsr is inert elsewhere,
    # so stacked cells would be duplicates); it subsumes lr stacking when
    # both are on, and degenerates to a one-bsr cell_grid with lr stacking.
    stack_bsr = (
        stack_bsr_axis
        and use_vmap
        and base_cfg.is_reg_method
        and len(bsr_values) > 1
        and all(b is not None for b in bsr_values)
        and (stack or len(lr_values) == 1)
    )
    bs_values = list(bs_list)
    stack_bs = (
        stack_bs_axis
        and use_vmap
        and len(bs_values) > 1
        and all(b is not None for b in bs_values)
        and (stack or len(lr_values) == 1)
        and (
            stack_bsr
            or len(bsr_values) == 1
            or (not base_cfg.is_reg_method
                and all(b is not None for b in bsr_values))
        )
    )
    all_results = {}

    def _cell_done(path):
        """A cell CSV counts as done only if it aggregates THIS seed count:
        the filename encodes hyperparameters, not seeds (reference naming),
        so a re-run with more seeds must not silently keep a smaller CSV.
        (Same-count different-seed re-runs still need a fresh
        --result_root — the CSV carries no seed identities.)"""
        if not os.path.isfile(path):
            return False
        with open(path) as f:
            data_lines = sum(1 for _ in f) - 1
        return data_lines == 5 * (len(seeds) + 2)

    def _run_stacked(cfg0, grid_cfgs):
        """One stacked program over (cells x seeds); per-cell CSVs."""
        if skip_existing:
            # per-cell resume semantics: stack only the missing cells
            # (the stack just shrinks; shapes pad per remaining rows)
            grid_cfgs = [
                c
                for c in grid_cfgs
                if not _cell_done(os.path.join(result_root, cell_filename(c)))
            ]
            if not grid_cfgs:
                return
        # mesh sharding needs rows = cells x seeds divisible by the data
        # axis: pad with copies of the last cell (whole cells keep the row
        # layout), whose rows are dropped below
        run_cfgs = grid_cfgs
        if mesh is not None:
            while (len(run_cfgs) * len(seeds)) % axis_size(mesh, "data"):
                run_cfgs = run_cfgs + [grid_cfgs[-1]]
        rows = train_seeds_vmapped(
            cfg0, bundle, seeds, verbose=verbose, mesh=mesh, cell_grid=run_cfgs,
            device=device,
        )
        n = len(seeds)
        for gi, cfg in enumerate(grid_cfgs):
            results = rows[gi * n : (gi + 1) * n]
            path = os.path.join(result_root, cell_filename(cfg))
            write(results, path)
            all_results[path] = results

    if stack_bs:
        grid_cfgs = []
        for bs in bs_values:
            cfg0 = base_cfg.replace(batch_size=bs)
            for bsr in bsr_values:
                c = cfg0 if bsr is None else cfg0.replace(batch_size_reg=bsr)
                grid_cfgs.extend(_cell_cfg(c, lr) for lr in lr_values)
        _run_stacked(base_cfg, grid_cfgs)
        return all_results

    if stack_bsr:
        for bs in bs_values:
            cfg0 = base_cfg if bs is None else base_cfg.replace(batch_size=bs)
            grid_cfgs = [
                _cell_cfg(cfg0.replace(batch_size_reg=bsr), lr)
                for bsr in bsr_values
                for lr in lr_values
            ]
            _run_stacked(cfg0, grid_cfgs)
        return all_results

    for bs in bs_values:
        for bsr in bsr_values:
            cfg0 = base_cfg
            if bs is not None:
                cfg0 = cfg0.replace(batch_size=bs)
            if bsr is not None:
                cfg0 = cfg0.replace(batch_size_reg=bsr)
            if stack:
                _run_stacked(cfg0, [_cell_cfg(cfg0, lr) for lr in lr_values])
            else:
                for lr in lr_values:
                    cfg = _cell_cfg(cfg0, lr)
                    path = os.path.join(result_root, cell_filename(cfg))
                    if skip_existing and _cell_done(path):
                        continue
                    results = run_seeds(
                        cfg, bundle, seeds, use_vmap=use_vmap,
                        verbose=verbose, mesh=mesh, device=device,
                    )
                    write(results, path)
                    all_results[path] = results
    return all_results
