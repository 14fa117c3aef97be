"""Stage B: the first steps of the stacked sweep against the plain f32
reference, row by row.

The sweep that set-up runs through ``train_seeds_vmapped`` is recorded at
the boundary of its stacked epochs: for the first epoch of each phase, the
state it starts from, each of its first ``CHECK_STEPS`` steps' per-row loss,
the momentum after its first step and the parameters after the last.  The
reference follows the same steps from the benchmark's initial weights (phase
1, and phase 2 where it starts the sweep) or from the program's own state at
the phase boundary (phase 2 after phase 1), with the batch plan, labels and
learning rates it works out from each row's seed.

Numbers (each against its limit in ``limits/<workload>.json``):

- ``loss_gap``: the widest ``|loss - loss_ref|`` over rows and phases at
  each phase's first step, against the larger of ``|loss_ref|`` and the
  median row's.  The later steps' losses are not compared: where a row's
  first step overshoots (its loss jumps from ~2 to ~100 at the temperature
  of 0.01), rounding at the level of one ulp decides a discrete branch of
  the next steps, and the f32 reference itself, its start or its inputs
  perturbed by 2**-24, reads a third step's loss 4e-5 to 7e-4 away from
  float64 on some rows (one in ten of its runs there).  What the later
  steps do is held by ``change_gap``;
- ``grad_gap``: for every live leaf (row, tensor), the gap between the norm
  of the momentum after the first step (the gradient as the optimizer takes
  it, weight decay included) and the reference's, against the larger of the
  reference's norm of that leaf and the median leaf's; the median of these
  gaps over the leaves;
- ``change_gap``: the same for the parameters' change over the steps, over
  the leaves whose reference gradient is at least a thousandth of the median
  leaf's.

The widest leaf gap swings from seed to seed by the rounding of one small
leaf (a BatchNorm bias whose gradient sums a batch of terms that nearly
cancel: 2e-4 of its norm on one seed in 26, 1e-6 on most), so the median leaf
is compared; :func:`worst_leaves` names the widest.
- ``start_gap``: the largest absolute difference between the state a phase
  starts from and what it must be (the initial weights, the phase-1 adapter
  kept frozen), exact.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.checks.common import leaf_gaps, median_leaf_gap
from portbench.reference import stage_b as ref

CHECK_STEPS = 3


class Recording:
    """What the program's first epoch of one phase did, stacked over rows."""

    def __init__(self, phase: int):
        self.phase = phase
        self.p0: Dict[str, torch.Tensor] = {}
        self.b0: Dict[str, torch.Tensor] = {}
        self.losses: List[torch.Tensor] = []
        self.trace1: Dict[str, torch.Tensor] = {}
        self.params: Dict[str, torch.Tensor] = {}
        self.steps = 0


def _row_steps(tr: dict, data: dict, phase: int, row: dict, device):
    """(batches of embeddings, labels, text, learning rates) of the row's
    first ``CHECK_STEPS`` steps of ``phase``."""
    t = tr["train"]
    feat = t["epochs_feature_learning"]
    balance = t.get("balance_val", False)
    order = ref.first_epoch_order(row, phase, len(data["train"]["y"]), data["reg"]["group"],
                                  feat, balance, 4)
    if phase == 1:
        split, bs, epoch = data["train"], row["bs"], 1
        labels, text = split["y"], data["text"]["class"]
    else:
        split, epoch = data["reg"], feat + 1
        bs = min(row["bsr"], len(order)) if balance else row["bsr"]
        group_prompt = t["tl_method"] == "adapter_reg_seq_alter" and epoch % 2 == 0
        labels = split["group"] if group_prompt else split["y"]
        text = data["text"]["group" if group_prompt else "class"]
    plan = ref.batches(order, bs)
    k = min(CHECK_STEPS, len(plan))
    if phase == 1:
        lrs = ref.phase1_lrs(row, epoch, len(plan), t["lr_decay_epochs"], t["lr_decay_rate"])
    else:
        lrs = ref.phase2_lrs(row, epoch, feat, len(plan), t["warm_reg"],
                             2 if tr["dataset"] == "celeba" else 10, t["lr_decay_epochs"],
                             t["lr_decay_rate"])
    emb = split["emb"]
    lab = torch.from_numpy(labels.astype(np.int64)).to(device)
    xs = [emb[torch.from_numpy(b).to(device)] for b in plan[:k]]
    ys = [lab[torch.from_numpy(b).to(device)] for b in plan[:k]]
    return xs, ys, torch.from_numpy(text).to(device), lrs[:k]


def _start(phase: int, i: int, feat: int, inits: List[dict], program: Optional[Recording]):
    """The row's starting parameters for the reference: the benchmark's
    initial weights, with the frozen old adapter taken from the program's
    state where phase 1 came before."""
    init = {k: torch.from_numpy(np.asarray(v)) for k, v in inits[i]["init_sd"].items()}
    if phase == 1:
        return {k: v for k, v in init.items() if not k.endswith(("running_mean", "running_var",
                                                                  "num_batches_tracked"))}
    new = {k: torch.from_numpy(np.asarray(v)) for k, v in inits[i]["ma_new_sd"].items()}
    p = {k: v for k, v in new.items() if k[len(ref.MULTIPLE_LIVE):] in ref.LEAF_NAMES}
    for leaf in ref.LEAF_NAMES:
        src = (init["adapter." + leaf] if feat == 0
               else program.p0[ref.MULTIPLE_OLD + leaf][i].detach().cpu())
        p[ref.MULTIPLE_OLD + leaf] = src
    return p


def reference_steps(tr: dict, data: dict, inits: List[dict], phases, device,
                    variant: str = "f32", program: Dict[int, Recording] = None):
    """Per phase, per row: (losses, first momentum, parameters after the
    steps, starting parameters), from the plain reference in ``variant``."""
    rows = ref.grid_rows(tr["grid"])
    t = tr["train"]
    out = {}
    for phase in phases:
        per_row = []
        for i, row in enumerate(rows):
            xs, ys, text, lrs = _row_steps(tr, data, phase, row, device)
            p0 = {k: v.to(device) for k, v in
                  _start(phase, i, t["epochs_feature_learning"], inits,
                         (program or {}).get(phase)).items()}
            losses, first, after = ref.train_steps(
                p0, xs, ys, text, lrs, momentum=t["momentum"], weight_decay=t["weight_decay"],
                temperature=t["zs_temperature"], variant=variant)
            per_row.append((losses, first, after, p0))
        out[phase] = per_row
    return out


def program_steps(recordings: Dict[int, Recording]):
    """The recordings in the layout of :func:`reference_steps`."""
    out = {}
    for phase, r in recordings.items():
        S = next(iter(r.p0.values())).shape[0]
        per_row = []
        for i in range(S):
            losses = [float(l[i]) for l in r.losses]
            first = {k: v[i] for k, v in r.trace1.items()}
            after = {k: v[i] for k, v in r.params.items()}
            p0 = {k: v[i] for k, v in r.p0.items()}
            per_row.append((losses, first, after, p0))
        out[phase] = per_row
    return out


def readings(side, reference) -> Dict[str, float]:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` of ``side`` (program or
    a stand-in) against the f32 reference, both in the layout of
    :func:`reference_steps`."""
    loss_gap = 0.0
    g_side, g_ref, d_side, d_ref = [], [], [], []
    for phase, rows in reference.items():
        # the first step's loss, from the state both sides start from; a
        # batch the model already fits has a loss near 0, so the gap is
        # taken against the larger of its loss and the median row's
        pairs = [(l_s[0], l_r[0]) for (l_r, *_), (l_s, *_) in zip(rows, side[phase]) if l_r]
        if pairs:
            median = sorted(abs(b) for _, b in pairs)[len(pairs) // 2]
            for a, b in pairs:
                loss_gap = max(loss_gap, abs(a - b) / max(abs(b), median, 1e-30))
        for (l_r, f_r, a_r, p_r), (l_s, f_s, a_s, p_s) in zip(rows, side[phase]):
            for name in f_r:
                g_side.append(ref.leaf_norm(f_s[name]))
                g_ref.append(ref.leaf_norm(f_r[name]))
                d_side.append(ref.leaf_norm(a_s[name] - p_s[name]))
                d_ref.append(ref.leaf_norm(a_r[name] - p_r[name]))
    median_g = sorted(g_ref)[len(g_ref) // 2]
    keep = [g >= 1e-3 * median_g for g in g_ref]
    return {"loss_gap": loss_gap, "grad_gap": median_leaf_gap(g_side, g_ref),
            "change_gap": median_leaf_gap(d_side, d_ref, keep)}


def worst_leaves(side, reference) -> Dict[str, dict]:
    """The leaf (phase, row, tensor) of the widest gap of the momentum after
    step 1 and of the change, with both norms and the median leaf's: where
    the tail of the readings comes from (not compared)."""
    out = {}
    for what in ("grad", "change"):
        leaves = []
        for phase, rows in reference.items():
            for i, ((_, f_r, a_r, p_r), (_, f_s, a_s, p_s)) in enumerate(zip(rows, side[phase])):
                for name in f_r:
                    if what == "grad":
                        s_t, r_t = f_s[name], f_r[name]
                    else:
                        s_t, r_t = a_s[name] - p_s[name], a_r[name] - p_r[name]
                    leaves.append((phase, i, name, ref.leaf_norm(s_t), ref.leaf_norm(r_t)))
        gaps = leaf_gaps([x[3] for x in leaves], [x[4] for x in leaves])
        worst = max(range(len(leaves)), key=gaps.__getitem__)
        phase, row, name, norm, norm_ref = leaves[worst]
        out[what] = {"phase": phase, "row": row, "leaf": name, "norm": norm,
                     "norm_ref": norm_ref, "gap": gaps[worst]}
    return out


def start_gap(recordings: Dict[int, Recording], inits: List[dict], feat: int,
              last_phase1: Optional[Dict[str, torch.Tensor]]) -> float:
    """The largest absolute difference between each phase's starting state
    (parameters and BatchNorm statistics) and what it must be."""
    worst = 0.0
    for phase, r in recordings.items():
        state = {**r.p0, **r.b0}
        for i in range(next(iter(state.values())).shape[0]):
            init = {**inits[i]["init_sd"], **inits[i]["ma_new_sd"]}
            for key, value in state.items():
                if key.startswith(ref.MULTIPLE_OLD):
                    want = (init["adapter." + key[len(ref.MULTIPLE_OLD):]] if feat == 0
                            else last_phase1["adapter." + key[len(ref.MULTIPLE_OLD):]][i])
                else:
                    want = init[key]
                want = torch.as_tensor(np.asarray(want) if not torch.is_tensor(want) else want)
                diff = (value[i].detach().cpu().double() - want.cpu().double()).abs()
                worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst if math.isfinite(worst) else math.inf
