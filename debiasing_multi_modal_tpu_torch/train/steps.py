"""Training and evaluation over whole epochs (port of ``train/steps.py``).

The JAX package runs an epoch as one jitted ``lax.scan``; here an epoch is
an eager loop over the batches of one plan (data/samplers.BatchPlan) that
never makes the host wait for the card: the embeddings, labels and groups
stay resident on the device, the epoch's ``[nb, B]`` plan is uploaded once,
each batch's rows are gathered on the device, each batch's learning rate is
a host float from the schedule (train/schedules.epoch_batch_lrs), and the
group-accuracy meters accumulate on the device (:class:`EpochStats`).  The
caller reads the totals once per epoch.

SGD reproduces torch semantics exactly: ``d = g + wd * p``,
``buf = momentum * buf + d``, ``p -= lr * buf`` (demo/util.py:118-136), with
a 0/1 mask per parameter standing in for ``set_optimizer_reg``'s parameter
filtering (the frozen old adapter): :func:`_sgd`.

Fixed shapes: the last partial batch is padded under a False mask
(drop_last=False parity); CE, BatchNorm statistics and metrics all honor the
mask, so numerics match the reference's variable-size final batch.  Each
epoch runs under one ``utils/platform.full_f32`` guard, so its products run
at full f32 precision on the card, backward included.

The stacked variants (``train_epoch_vmapped``, ``eval_epoch_vmapped``, the
JAX package's vmapped epochs) train S rows at once, each its own classifier
(:class:`StackedState`: every tensor carries a leading row axis) on the
shared embeddings: one set of launches per step for every row, the
products as ``torch.baddbmm``, one ``backward`` of the sum of the rows'
losses (which gives each row exactly its own gradient), a per-row learning
rate from an ``[S, nb]`` device tensor, and an ``active [S, nb]`` flag that
makes a row's padded step a true no-op.

Data parallelism (``train/loop.py::shard_bundle``): with a ``shard``
(:class:`~debiasing_multi_modal_tpu_torch.parallel.mesh.RowShard`) the
embeddings are this rank's block of the split's rows, and each rank runs
every batch of the shared plan on the rows it holds (the others masked
out).  The masked BatchNorm sums and counts are all-reduced over the
shard's group, each rank's CE is its rows' share of the batch mean (the
divisor all-reduced), the gradients are all-reduced before the update and
the epoch's meters once at its end, so the parameters, the running
statistics and the meters are the unsharded run's up to the order of the
sums.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from debiasing_multi_modal_tpu_torch.models.adapter import MaskedBatchNorm, stacked_logits
from debiasing_multi_modal_tpu_torch.parallel.mesh import RowShard
from debiasing_multi_modal_tpu_torch.train.losses import masked_cross_entropy
from debiasing_multi_modal_tpu_torch.train.metrics import batch_group_counts, stacked_group_counts
from debiasing_multi_modal_tpu_torch.utils.platform import full_f32
from debiasing_multi_modal_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass
class TrainState:
    """A classifier (its parameters and BatchNorm statistics) and the SGD
    momentum buffers, keyed by parameter name."""

    module: nn.Module
    trace: Dict[str, torch.Tensor]

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.module.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.module.named_buffers())


def _zero_trace(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
            for n, p in module.named_parameters()}


def init_train_state(module: nn.Module) -> TrainState:
    return TrainState(module, _zero_trace(module))


def reset_optimizer(state: TrainState) -> TrainState:
    """Fresh momentum at the phase boundary (final_main.py:947-950)."""
    return TrainState(state.module, _zero_trace(state.module))


def ones_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {n: 1.0 for n in params}


def freeze_subtrees(params: Mapping[str, torch.Tensor],
                    frozen_names: Sequence[str]) -> Dict[str, float]:
    """0/1 mask: 0 for parameters under any top-level module named in
    ``frozen_names`` (the multiple classifier's old branch is ``old_cls``,
    the JAX package's ``old`` subtree)."""
    return {n: 0.0 if n.split(".", 1)[0] in frozen_names else 1.0 for n in params}


def _live(mask: Mapping[str, float]) -> Tuple[list, list]:
    bad = {n: m for n, m in mask.items() if m not in (0.0, 1.0)}
    if bad:
        raise ValueError(f"a train mask takes 0 or 1 per parameter, got {bad}")
    return ([n for n, m in mask.items() if m == 1.0],
            [n for n, m in mask.items() if m == 0.0])


@torch.no_grad()
def _sgd(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
         trace: Mapping[str, torch.Tensor], lr: float, momentum: float,
         weight_decay: float, mask: Mapping[str, float]) -> None:
    """One SGD step in place.  The mask gates the WHOLE update, not just the
    grad + wd term: torch's set_optimizer_reg EXCLUDES frozen params from the
    optimizer entirely (demo/util.py:125-136), so a frozen param does not
    move even if its momentum buffer holds a stale nonzero trace, and its
    trace becomes ``(...) * 0``, zero.  A live param without a gradient
    (``grads`` lacks it) takes a zero gradient."""
    live, frozen = _live(mask)
    if frozen:
        torch._foreach_zero_([trace[n] for n in frozen])
    if not live:
        return
    t = [trace[n] for n in live]
    p = [params[n] for n in live]
    g = [grads[n] if grads.get(n) is not None else torch.zeros_like(params[n])
         for n in live]
    torch._foreach_mul_(t, momentum)
    torch._foreach_add_(t, g)
    torch._foreach_add_(t, p, alpha=weight_decay)
    torch._foreach_add_(p, t, alpha=-lr)


class EpochStats(NamedTuple):
    corrects: torch.Tensor  # [n_groups] f32
    counts: torch.Tensor  # [n_groups] f32
    loss_sum: torch.Tensor  # sum(loss * n_valid)
    n: torch.Tensor  # total valid examples

    @staticmethod
    def zeros(n_groups: int, device, rows: Optional[int] = None) -> "EpochStats":
        """Zero meters; with ``rows``, one set per stacked row."""
        lead = () if rows is None else (rows,)

        def z(*shape):
            return torch.zeros(lead + shape, dtype=torch.float32, device=device)
        return EpochStats(z(n_groups), z(n_groups), z(), z())

    def merge(self, other: "EpochStats") -> "EpochStats":
        """Field-wise accumulation (the reference's meters accumulate both
        the train and the class-prompt reg pass, final_main.py:536,551)."""
        return EpochStats(*(a + b for a, b in zip(self, other)))

    @torch.no_grad()
    def add_batch(self, logits, labels, groups, mask, loss, loss_weight=None) -> None:
        """Accumulate one (padded) batch in place, on the device;
        ``loss_weight`` replaces the batch's valid-row count as the loss's
        weight (a data-parallel rank's share weighs by the whole batch's)."""
        corrects, counts = batch_group_counts(logits, labels, groups, mask,
                                              self.counts.shape[0])
        self.corrects.add_(corrects)
        self.counts.add_(counts)
        nvalid = mask.to(torch.float32).sum()
        self.loss_sum.add_(loss.detach() * (nvalid if loss_weight is None else loss_weight))
        self.n.add_(nvalid)

    def all_reduce(self, group) -> "EpochStats":
        """Every meter summed over ``group``'s ranks, in one collective."""
        return EpochStats(*_summed(list(self), group))


    @torch.no_grad()
    def add_stacked(self, logits, labels, groups, mask, loss) -> None:
        """:meth:`add_batch` for S stacked rows (``groups`` int64).  A
        padded step's row is all-masked, so it adds nothing."""
        corrects, counts = stacked_group_counts(logits, labels, groups, mask,
                                                self.counts.shape[-1])
        self.corrects.add_(corrects)
        self.counts.add_(counts)
        nvalid = mask.to(torch.float32).sum(-1)
        self.loss_sum.add_(loss.detach() * nvalid)
        self.n.add_(nvalid)


@contextlib.contextmanager
def _batch_stats_over(module: nn.Module, shard: Optional[RowShard]):
    """The module's masked BatchNorms take their statistics over the
    shard's group inside the block."""
    if shard is None:
        yield
        return
    bns = [m for m in module.modules() if isinstance(m, MaskedBatchNorm)]
    for bn in bns:
        bn.group = shard.group
    try:
        yield
    finally:
        for bn in bns:
            bn.group = None


def _batch(embeddings, labels, b_idx, b_mask, shard):
    """A batch's rows, labels and mask; with a shard, this rank's rows of
    it, the mask narrowed to them, and the batch's valid-row count."""
    if shard is None:
        return embeddings[b_idx], labels[b_idx], b_mask, None
    local, mask = shard.rows_of(b_idx, b_mask)
    count = b_mask.to(torch.float32).sum()  # every rank holds the whole plan
    return embeddings[local], labels[b_idx], mask, count


def _summed(tensors, group):
    """Each tensor summed over ``group``'s ranks, in one collective on one
    flat buffer; a None stays None."""
    present = [t for t in tensors if t is not None]
    if not present:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in present])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        if t is not None:
            t = flat[at:at + t.numel()].view_as(t)
            at += t.numel()
        out.append(t)
    return out


def train_epoch(
    state: TrainState,
    embeddings: torch.Tensor,  # [N, D] resident on the device
    labels: torch.Tensor,  # [N] int64 — already the chosen target
    groups: torch.Tensor,  # [N] int64 — for metrics
    idx: torch.Tensor,  # [nb, B] int64 batch plan, on the device
    mask: torch.Tensor,  # [nb, B] bool, on the device
    lrs: np.ndarray,  # [nb] float32, on the host
    text: torch.Tensor,  # [D, C] un-normalized text matrix
    train_mask: Mapping[str, float],  # 0/1 per parameter name
    *,
    n_groups: int = 4,
    momentum: float = 0.9,
    weight_decay: float = 5e-5,
    shard: Optional[RowShard] = None,
) -> Tuple[TrainState, EpochStats]:
    """One epoch of SGD in training mode (the JAX ``_train_epoch_impl``);
    updates ``state`` in place and returns it with the epoch's meters.
    With ``shard``, the epoch is data-parallel (module docstring)."""
    module = state.module.train()
    params = state.params
    live, _ = _live(train_mask)
    live_params = [params[n] for n in live]
    stats = EpochStats.zeros(n_groups, embeddings.device)
    lrs = np.asarray(lrs, np.float32)
    with full_f32(), _batch_stats_over(module, shard):
        for b in range(idx.shape[0]):
            x, lab, b_mask, count = _batch(embeddings, labels, idx[b], mask[b], shard)
            logits = module(x, text, b_mask)
            loss = masked_cross_entropy(logits, lab, b_mask, count)
            grads = torch.autograd.grad(loss, live_params, allow_unused=True)
            if shard is not None:
                grads = _summed(grads, shard.group)
            _sgd(params, dict(zip(live, grads)), state.trace, float(lrs[b]),
                 momentum, weight_decay, train_mask)
            stats.add_batch(logits, lab, groups[idx[b]], b_mask, loss, count)
    return state, stats if shard is None else stats.all_reduce(shard.group)


@torch.no_grad()
def eval_epoch(
    module: nn.Module,
    embeddings: torch.Tensor,
    labels: torch.Tensor,
    groups: torch.Tensor,
    idx: torch.Tensor,
    mask: torch.Tensor,
    text: torch.Tensor,
    *,
    n_groups: int = 4,
    shard: Optional[RowShard] = None,
) -> EpochStats:
    """Evaluation with running BatchNorm statistics (classifier.eval());
    with ``shard``, data-parallel as :func:`train_epoch`."""
    module.eval()
    stats = EpochStats.zeros(n_groups, embeddings.device)
    with full_f32():
        for b in range(idx.shape[0]):
            x, lab, b_mask, count = _batch(embeddings, labels, idx[b], mask[b], shard)
            logits = module(x, text, b_mask)
            loss = masked_cross_entropy(logits, lab, b_mask, count)
            stats.add_batch(logits, lab, groups[idx[b]], b_mask, loss, count)
    return stats if shard is None else stats.all_reduce(shard.group)


# ------------------------------------------------ stacked rows (the sweep) --


@dataclasses.dataclass
class StackedState:
    """S classifiers of one kind: parameters, BatchNorm buffers and SGD
    momentum keyed by the module's state-dict names, each tensor with a
    leading row axis.  ``temperature`` is the zero-shot head's."""

    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    trace: Dict[str, torch.Tensor]
    temperature: float = 0.01

    @property
    def rows(self) -> int:
        return next(iter(self.params.values())).shape[0]

    @staticmethod
    def from_tensors(params: Mapping[str, torch.Tensor], buffers: Mapping[str, torch.Tensor],
                     temperature: float = 0.01) -> "StackedState":
        """Fresh leaves (copies, parameters requiring grad) and zero momentum."""
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        b = {k: v.detach().clone() for k, v in buffers.items()}
        return StackedState(p, b, {k: torch.zeros_like(v) for k, v in p.items()}, temperature)

    @staticmethod
    def stack(modules: Sequence[nn.Module], device, temperature: float = 0.01) -> "StackedState":
        """One row per module (all of one class), on ``device``."""
        def stacked(named):
            names = [n for n, _ in named(modules[0])]
            return {n: torch.stack([dict(named(m))[n].detach() for m in modules]).to(device)
                    for n in names}
        return StackedState.from_tensors(stacked(lambda m: m.named_parameters()),
                                         stacked(lambda m: m.named_buffers()), temperature)

    def row_state_dict(self, i: int) -> Dict[str, torch.Tensor]:
        """Row ``i`` as its module's state dict."""
        return {k: v[i].detach() for k, v in {**self.params, **self.buffers}.items()}


@torch.no_grad()
def _sgd_stacked(params: Mapping[str, torch.Tensor], grads: Sequence[Optional[torch.Tensor]],
                 trace: Mapping[str, torch.Tensor], neg_lr: torch.Tensor, momentum: float,
                 weight_decay: float, live: List[str],
                 active: Optional[torch.Tensor]) -> None:
    """:func:`_sgd` for S stacked rows in place, ``neg_lr [S]`` the rows'
    negated learning rates.  A row whose ``active`` entry is False keeps
    its parameters and its momentum (a zero learning rate would still decay
    the trace)."""
    if not live:
        return
    t = [trace[n] for n in live]
    p = [params[n] for n in live]
    g = [gr if gr is not None else torch.zeros_like(pp) for gr, pp in zip(grads, p)]

    def per_row(x, v):
        return v.view((-1,) + (1,) * (x.dim() - 1))

    new_t = t if active is None else [x.clone() for x in t]
    torch._foreach_mul_(new_t, momentum)
    torch._foreach_add_(new_t, g)
    torch._foreach_add_(new_t, p, alpha=weight_decay)
    step = torch._foreach_mul(new_t, [per_row(x, neg_lr) for x in new_t])
    if active is None:
        torch._foreach_add_(p, step)
        return
    for tt, nt, pp, st in zip(t, new_t, p, step):
        a = per_row(tt, active)
        tt.copy_(torch.where(a, nt, tt))
        pp.copy_(torch.where(a, pp + st, pp))


def train_epoch_vmapped(
    state: StackedState,
    embeddings: torch.Tensor,  # [N, D] shared by every row
    labels: torch.Tensor,  # [N] int64
    groups: torch.Tensor,  # [N] int64
    idx: torch.Tensor,  # [S, nb, B] int64, each row's plan
    mask: torch.Tensor,  # [S, nb, B] bool
    lrs: torch.Tensor,  # [nb] shared or [S, nb] per row, on the device
    text: torch.Tensor,  # [D, C]
    train_mask: Mapping[str, float],
    *,
    active: Optional[torch.Tensor] = None,  # [S, nb] bool: False on padded steps
    n_groups: int = 4,
    momentum: float = 0.9,
    weight_decay: float = 5e-5,
) -> Tuple[StackedState, EpochStats]:
    """S rows' epochs at once (the JAX ``train_epoch_vmapped``); updates
    ``state`` in place and returns it with ``[S, ...]`` meters.  Row ``i``
    computes what :func:`train_epoch` computes on its own plan."""
    live, frozen = _live(train_mask)
    params = state.params
    live_params = [params[n] for n in live]
    S, nb = idx.shape[:2]
    stats = EpochStats.zeros(n_groups, embeddings.device, rows=S)
    neg_lrs = -(lrs if lrs.dim() == 2 else lrs.expand(S, -1))
    if frozen:
        # the frozen parameters' momentum is zero after any step (_sgd)
        torch._foreach_zero_([state.trace[n] for n in frozen])
    with full_f32():
        for b in range(nb):
            with annotate("sweep.step"):
                b_idx, b_mask = idx[:, b], mask[:, b]
                act = None if active is None else active[:, b]
                lab = labels[b_idx]
                logits = stacked_logits(params, state.buffers, embeddings[b_idx], text,
                                        state.temperature, b_mask, True, act)
                loss = masked_cross_entropy(logits, lab, b_mask)
                grads = torch.autograd.grad(loss.sum(), live_params, allow_unused=True)
                _sgd_stacked(params, grads, state.trace, neg_lrs[:, b], momentum, weight_decay,
                             live, act)
                stats.add_stacked(logits, lab, groups[b_idx], b_mask, loss)
    return state, stats


@torch.no_grad()
def eval_epoch_vmapped(
    state: StackedState,
    embeddings: torch.Tensor,
    labels: torch.Tensor,  # [N] int64
    groups: torch.Tensor,  # [N] int64
    idx: torch.Tensor,  # [nb, B] one plan for every row
    mask: torch.Tensor,  # [nb, B]
    text: torch.Tensor,
    *,
    n_groups: int = 4,
) -> EpochStats:
    """S rows evaluated with their running BatchNorm statistics."""
    S = state.rows
    stats = EpochStats.zeros(n_groups, embeddings.device, rows=S)
    with full_f32():
        for b in range(idx.shape[0]):
            b_idx = idx[b]
            b_mask = mask[b].expand(S, -1)
            lab = labels[b_idx].expand(S, -1)
            x = embeddings[b_idx].expand(S, -1, -1)
            logits = stacked_logits(state.params, state.buffers, x, text, state.temperature,
                                    b_mask, False)
            loss = masked_cross_entropy(logits, lab, b_mask)
            stats.add_stacked(logits, lab, groups[b_idx].expand(S, -1), b_mask, loss)
    return stats
