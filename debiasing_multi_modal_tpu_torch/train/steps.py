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
at full f32 precision on the card, backward included.  The vmapped variants (``train_epoch_vmapped``,
``eval_epoch_vmapped``) wait for the sweep slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from debiasing_multi_modal_tpu_torch.train.losses import masked_cross_entropy
from debiasing_multi_modal_tpu_torch.train.metrics import batch_group_counts
from debiasing_multi_modal_tpu_torch.utils.platform import full_f32


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
    def zeros(n_groups: int, device) -> "EpochStats":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return EpochStats(z(n_groups), z(n_groups), z(), z())

    def merge(self, other: "EpochStats") -> "EpochStats":
        """Field-wise accumulation (the reference's meters accumulate both
        the train and the class-prompt reg pass, final_main.py:536,551)."""
        return EpochStats(*(a + b for a, b in zip(self, other)))

    @torch.no_grad()
    def add_batch(self, logits, labels, groups, mask, loss) -> None:
        """Accumulate one (padded) batch in place, on the device."""
        corrects, counts = batch_group_counts(logits, labels, groups, mask,
                                              self.counts.shape[0])
        self.corrects.add_(corrects)
        self.counts.add_(counts)
        nvalid = mask.to(torch.float32).sum()
        self.loss_sum.add_(loss.detach() * nvalid)
        self.n.add_(nvalid)


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
) -> Tuple[TrainState, EpochStats]:
    """One epoch of SGD in training mode (the JAX ``_train_epoch_impl``);
    updates ``state`` in place and returns it with the epoch's meters."""
    module = state.module.train()
    params = state.params
    live, _ = _live(train_mask)
    live_params = [params[n] for n in live]
    stats = EpochStats.zeros(n_groups, embeddings.device)
    lrs = np.asarray(lrs, np.float32)
    with full_f32():
        for b in range(idx.shape[0]):
            b_idx, b_mask = idx[b], mask[b]
            lab = labels[b_idx]
            logits = module(embeddings[b_idx], text, b_mask)
            loss = masked_cross_entropy(logits, lab, b_mask)
            grads = torch.autograd.grad(loss, live_params, allow_unused=True)
            _sgd(params, dict(zip(live, grads)), state.trace, float(lrs[b]),
                 momentum, weight_decay, train_mask)
            stats.add_batch(logits, lab, groups[b_idx], b_mask, loss)
    return state, stats


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
) -> EpochStats:
    """Evaluation with running BatchNorm statistics (classifier.eval())."""
    module.eval()
    stats = EpochStats.zeros(n_groups, embeddings.device)
    with full_f32():
        for b in range(idx.shape[0]):
            b_idx, b_mask = idx[b], mask[b]
            lab = labels[b_idx]
            logits = module(embeddings[b_idx], text, b_mask)
            loss = masked_cross_entropy(logits, lab, b_mask)
            stats.add_batch(logits, lab, groups[b_idx], b_mask, loss)
    return stats
