"""Plain Stage-B training steps in float32 with TF32 off, one row at a time,
and the batch plans and learning rates each row's first epoch of a phase
takes, worked out from the row's seed.

The model is the reference's ``final_main.py``: ``Adapter`` = Linear(D->H),
BatchNorm1d (batch statistics in training, biased variance), ReLU,
Linear(H->D); ``CustomCLIP`` = adapter, row L2-normalization, product with
the column-normalized text matrix over the temperature; ``MultipleAdapter``
= the frozen old adapter and the new one, each row-normalized, blended
0.5/0.5 before the text product.  The loss is the mean cross-entropy and the
update torch's SGD with momentum and weight decay (``d = g + wd * p``,
``buf = m * buf + d``, ``p -= lr * buf``).

The samplers follow the reference's loaders: a fresh permutation per epoch
(``DataLoader(shuffle=True)``, drawn from each row's numpy generator), the
regularization half of the val split (``train_test_split`` stratified on the
group, ``random_state=42``), and ``balance_val``'s per-epoch group-balanced
subset, interleaved round-robin.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

MULTIPLE_LIVE = "new_adapter."
MULTIPLE_OLD = "old_cls.adapter."
LEAF_NAMES = ("layers.0.weight", "layers.0.bias", "layers.1.weight", "layers.1.bias",
              "layers.3.weight", "layers.3.bias")


# ----------------------------------------------------------------- rows --


def grid_rows(grid: dict) -> List[dict]:
    """The stacked rows in the sweep's order: cells (batch size outer, then
    the reg batch size, then the learning rate), each over every seed."""
    rows = []
    for bs in grid["bs"]:
        for bsr in grid["bsr"]:
            for lr in grid["lr"]:
                for seed in grid["seeds"]:
                    rows.append({"bs": bs, "bsr": bsr, "lr": float(lr),
                                 "lrr": float(lr) * grid["lr_multiple"], "seed": int(seed)})
    return rows


def reg_split(group: np.ndarray, seed: int = 42):
    """(reg indices, val indices): the val split halved, stratified on the
    group (sklearn's ``train_test_split`` where installed; otherwise each
    group shuffled and cut at half)."""
    n = len(group)
    try:
        from sklearn.model_selection import train_test_split
    except ImportError:
        rng = np.random.default_rng(seed)
        reg, val = [], []
        for g in np.unique(group):
            idx = np.where(group == g)[0]
            rng.shuffle(idx)
            cut = int(round(len(idx) * 0.5))
            reg.append(idx[:cut])
            val.append(idx[cut:])
        return np.concatenate(reg), np.concatenate(val)
    reg, val = train_test_split(np.arange(n), test_size=0.5, random_state=seed, stratify=group)
    return np.asarray(reg), np.asarray(val)


def balanced_order(group: np.ndarray, rng: np.random.Generator, n_groups: int) -> np.ndarray:
    per = [np.where(group == g)[0] for g in range(n_groups)]
    m = min(len(p) for p in per)
    picked = []
    for p in per:
        p = p.copy()
        rng.shuffle(p)
        picked.append(p[:m])
    return np.stack(picked, axis=1).reshape(-1)


def first_epoch_order(row: dict, phase: int, n_train: int, reg_group: Optional[np.ndarray],
                      feat_epochs: int, balance: bool, n_groups: int) -> np.ndarray:
    """The sample order of the row's first epoch of ``phase``, replaying its
    generator's draws from the start of the sweep."""
    rng = np.random.default_rng(row["seed"])

    def epoch(feature_learning: bool) -> np.ndarray:
        # each epoch first draws its balanced reg order, then its plan
        balanced = balanced_order(reg_group, rng, n_groups) if balance else None
        if feature_learning:
            return rng.permutation(n_train)
        return balanced if balanced is not None else rng.permutation(len(reg_group))

    if phase == 1:
        return epoch(True)
    for _ in range(feat_epochs):
        epoch(True)
    return epoch(False)


def batches(order: np.ndarray, bs: int) -> List[np.ndarray]:
    return [order[i:i + bs] for i in range(0, len(order), bs)]


def phase2_lrs(row: dict, epoch: int, feat_epochs: int, nb: int, warm_reg: bool,
               warm_epochs: int, decay_epochs: Sequence[int], decay_rate: float) -> List[float]:
    """The row's learning rate at each batch of phase-2 ``epoch``: the linear
    warm-up from lrr/100 over the first ``warm_epochs`` epochs of the phase,
    else the step decay at the absolute-epoch milestones."""
    rel = epoch - feat_epochs
    if warm_reg and rel <= warm_epochs:
        lo, hi = row["lrr"] / 100, row["lrr"]
        return [lo + (b + (rel - 1) * nb) / (warm_epochs * nb) * (hi - lo) for b in range(nb)]
    steps = sum(epoch > m for m in decay_epochs)
    return [row["lrr"] * decay_rate ** steps] * nb


def phase1_lrs(row: dict, epoch: int, nb: int, decay_epochs: Sequence[int],
               decay_rate: float) -> List[float]:
    steps = sum(epoch > m for m in decay_epochs)
    return [row["lr"] * decay_rate ** steps] * nb


# ---------------------------------------------------------------- model --


def _adapter(p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor) -> torch.Tensor:
    h = x @ p[prefix + "layers.0.weight"].T + p[prefix + "layers.0.bias"]
    mean = h.mean(0)
    var = ((h - mean) ** 2).mean(0)
    h = (h - mean) / torch.sqrt(var + 1e-5) * p[prefix + "layers.1.weight"] \
        + p[prefix + "layers.1.bias"]
    return torch.relu(h) @ p[prefix + "layers.3.weight"].T + p[prefix + "layers.3.bias"]


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True)


def logits(p: Dict[str, torch.Tensor], x: torch.Tensor, text: torch.Tensor,
           temperature: float) -> torch.Tensor:
    text_n = text / text.norm(dim=0, keepdim=True)
    if MULTIPLE_LIVE + "layers.0.weight" in p:
        with torch.no_grad():
            old = _rows(_adapter(p, MULTIPLE_OLD, x))
        feat = 0.5 * old + 0.5 * _rows(_adapter(p, MULTIPLE_LIVE, x))
    else:
        feat = _rows(_adapter(p, "adapter.", x))
    return feat @ text_n / temperature


def live_names(p: Dict[str, torch.Tensor]) -> List[str]:
    prefix = MULTIPLE_LIVE if MULTIPLE_LIVE + "layers.0.weight" in p else "adapter."
    return [prefix + n for n in LEAF_NAMES]


@contextlib.contextmanager
def precision(variant: str):
    """``f32`` and the faults keep TF32 off; ``tf32`` (the control) turns
    it on for every product."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on = variant == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def train_steps(p0: Dict[str, torch.Tensor], xs: Sequence[torch.Tensor],
                ys: Sequence[torch.Tensor], text: torch.Tensor, lrs: Sequence[float], *,
                momentum: float, weight_decay: float, temperature: float,
                variant: str = "f32"):
    """SGD steps of one row from ``p0`` (name -> tensor) over the batches
    ``xs`` with labels ``ys``: returns (per-step losses, the momentum after
    the first step (the gradient as the optimizer takes it), the parameters
    after the last step).  ``variant`` "half_batch" trains on the first half
    of each batch only, the mean over those rows."""
    live = live_names(p0)
    p = {k: v.detach().clone().requires_grad_(k in live) for k, v in p0.items()}
    trace = {k: torch.zeros_like(p[k]) for k in live}
    losses, first = [], None
    with precision(variant):
        for step, (x, y, lr) in enumerate(zip(xs, ys, lrs)):
            if variant == "half_batch":
                x, y = x[: max(1, len(x) // 2)], y[: max(1, len(y) // 2)]
            out = logits(p, x, text, temperature)
            loss = torch.nn.functional.cross_entropy(out, y)
            grads = torch.autograd.grad(loss, [p[k] for k in live])
            with torch.no_grad():
                for k, g in zip(live, grads):
                    trace[k].mul_(momentum).add_(g + weight_decay * p[k])
                    p[k].sub_(lr * trace[k])
            losses.append(float(loss.detach()))
            if step == 0:
                first = {k: v.clone() for k, v in trace.items()}
    return losses, first, {k: v.detach() for k, v in p.items()}


def leaf_norm(t: torch.Tensor) -> float:
    return math.sqrt(float((t.double() ** 2).sum()))
