"""Learning-rate schedules as pure functions of (epoch, batch index) (the
port's copy of ``train/schedules.py``).

Parity surface: reference ``demo/util.py`` — ``adjust_learning_rate`` (:70-82,
epoch-level step decay or cosine), ``adjust_learning_rate_reg`` (:84-96, same
but from ``learning_rate_reg``; its cosine branch has a typo in the reference
and is reproduced *fixed*), ``warmup_learning_rate`` (:99-106, linear batch-
wise warmup that *overrides* the epoch LR while ``epoch <= warm_epochs``) and
``warmup_learning_rate_reg`` (:108-115, indexed by ``epoch -
epochs_feature_learning``, final_main.py:607).

Everything returns plain floats computed on the host: the epoch step reads
each batch's LR from the host vector, so no LR ever waits on the card.
"""

from __future__ import annotations

import math

import numpy as np

from debiasing_multi_modal_tpu_torch.train.config import TrainConfig


def epoch_lr(cfg: TrainConfig, epoch: int) -> float:
    """Phase-1 LR at the start of ``epoch`` (1-based)."""
    lr = cfg.learning_rate
    if cfg.cosine:
        eta_min = lr * (cfg.lr_decay_rate ** 3)
        return eta_min + (lr - eta_min) * (1 + math.cos(math.pi * epoch / cfg.epochs)) / 2
    steps = int(np.sum(epoch > np.asarray(cfg.lr_decay_epochs)))
    return lr * (cfg.lr_decay_rate ** steps) if steps > 0 else lr


def epoch_lr_reg(cfg: TrainConfig, epoch: int) -> float:
    """Phase-2 LR; ``epoch`` is the *absolute* epoch number (decay milestones
    are absolute in the reference, e.g. '90,95' with feature learning 40)."""
    lr = cfg.learning_rate_reg
    if cfg.cosine:
        assert cfg.epochs_feature_learning is not None
        span = cfg.epochs - cfg.epochs_feature_learning
        eta_min = lr * (cfg.lr_decay_rate ** 3)
        return eta_min + (lr - eta_min) * (1 + math.cos(math.pi * epoch / span)) / 2
    steps = int(np.sum(epoch > np.asarray(cfg.lr_decay_epochs)))
    return lr * (cfg.lr_decay_rate ** steps) if steps > 0 else lr


def _linear_warmup(frm: float, to: float, epoch: int, batch_idx: int,
                   total_batches: int, warm_epochs: int) -> float:
    p = (batch_idx + (epoch - 1) * total_batches) / (warm_epochs * total_batches)
    return frm + p * (to - frm)


def batch_lr(
    cfg: TrainConfig, epoch: int, batch_idx: int, total_batches: int
) -> float:
    """Effective phase-1 LR for one batch (warmup overrides epoch LR)."""
    if cfg.warm and epoch <= cfg.warm_epochs:
        return _linear_warmup(
            cfg.warmup_from, cfg.warmup_to, epoch, batch_idx, total_batches,
            cfg.warm_epochs,
        )
    return epoch_lr(cfg, epoch)


def batch_lr_reg(
    cfg: TrainConfig, epoch: int, batch_idx: int, total_batches: int
) -> float:
    """Effective phase-2 LR for one batch.  Warmup progress is indexed by the
    epoch offset into phase 2; the decayed LR by the absolute epoch."""
    assert cfg.epochs_feature_learning is not None
    rel_epoch = epoch - cfg.epochs_feature_learning
    if cfg.warm_reg and rel_epoch <= cfg.warm_epochs_reg:
        return _linear_warmup(
            cfg.warmup_from_reg, cfg.warmup_to_reg, rel_epoch, batch_idx,
            total_batches, cfg.warm_epochs_reg,
        )
    return epoch_lr_reg(cfg, epoch)


def epoch_batch_lrs(
    cfg: TrainConfig, epoch: int, total_batches: int, phase: int
) -> np.ndarray:
    """All per-batch LRs for one epoch as a float32 vector (scan input)."""
    fn = batch_lr if phase == 1 else batch_lr_reg
    return np.asarray(
        [fn(cfg, epoch, b, total_batches) for b in range(total_batches)],
        np.float32,
    )
