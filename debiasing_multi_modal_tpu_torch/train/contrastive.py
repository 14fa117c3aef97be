"""Contrastive-adapter training: supervised-contrastive fine-tuning of the
embedding adapter (port of ``train/contrastive.py``).

Parity surface: reference ``demo/visualizer_supcon.py`` ``train_one_epoch_cl``
(:412-508) + ``SupervisedContrastiveLoss`` (:1522-1587): per anchor row
``[anchor | positives | negatives]``, cosine similarities of adapted features
at temperature 0.1, ``-log(exp_pos / (sum exp_pos + sum exp_neg))`` averaged
over positives; gradients accumulated over ``batch_factor`` rows per step.

An epoch is an eager loop over the epoch's ``[nb, rows_per_step, A+P+N]``
row-index tensor, uploaded once: each step gathers its rows from the
resident embeddings, optionally L2-normalizes them before the adapter
(``ca_pre_norm``: the effective reference configuration, visualizer_supcon.py
:258), runs the encoder (train/loop.py passes a ``models/adapter.CAEncoder``
around the classifier's own adapter) in training mode, and takes one SGD step
on ``contrastive_weight`` times the mean row loss, which equals the
reference's accumulated gradient (loss = contrastive_weight * supcon /
batch_factor per anchor, visualizer_supcon.py:477-479).  The adapter's
BatchNorm sees the step's flattened ``R * (A+P+N)`` rows at once, the JAX
package's documented deviation from the reference (which normalizes each
anchor/pos and anchor/neg sub-batch): the statistics differ only in grouping.
Only the first anchor of a row enters the loss; the extra anchors pass
through the BatchNorm, as in the JAX package.

The per-step losses stay on the device; the caller reads them once per epoch.
Each epoch runs under one ``utils/platform.full_f32`` guard.
``train_contrastive_epoch_vmapped`` is the stacked form for the sweep.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from debiasing_multi_modal_tpu_torch.models.adapter import stacked_encoder
from debiasing_multi_modal_tpu_torch.train.losses import supcon_loss
from debiasing_multi_modal_tpu_torch.train.steps import (
    StackedState,
    TrainState,
    _live,
    _sgd,
    _sgd_stacked,
)
from debiasing_multi_modal_tpu_torch.utils.platform import full_f32


def _step_loss(adapted: torch.Tensor, r: int, a: int, p: int, temperature: float,
               contrastive_weight: float) -> torch.Tensor:
    """``adapted [..., R * (A+P+N), F]`` -> the weighted SupCon loss ``[...]``."""
    adapted = adapted.reshape(adapted.shape[:-2] + (r, -1, adapted.shape[-1]))
    anchor = adapted[..., 0, :]
    pos = adapted[..., a:a + p, :]
    neg = adapted[..., a + p:, :]
    return contrastive_weight * supcon_loss(anchor, pos, neg, temperature)


def _prenorm(emb: torch.Tensor, ca_pre_norm: bool) -> torch.Tensor:
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True) if ca_pre_norm else emb


def train_contrastive_epoch(
    state: TrainState,  # the encoder (adapter, optional head) and its momentum
    embeddings: torch.Tensor,  # [N, D] resident on the device
    rows: torch.Tensor,  # [nb, rows_per_step, A + P + N] int64, on the device
    lrs: np.ndarray,  # [nb] float32, on the host
    train_mask: Mapping[str, float],
    *,
    num_anchor: int,
    num_positive: int,
    num_negative: int,
    temperature: float = 0.1,
    contrastive_weight: float = 0.1,
    ca_pre_norm: bool = True,
    momentum: float = 0.9,
    weight_decay: float = 5e-5,
) -> Tuple[TrainState, torch.Tensor]:
    """One SupCon epoch in place; returns the state and the ``[nb]`` step
    losses on the device."""
    module = state.module.train()
    params = state.params
    live, _ = _live(train_mask)
    live_params = [params[n] for n in live]
    nb, r = rows.shape[:2]
    losses = torch.zeros(nb, dtype=torch.float32, device=embeddings.device)
    lrs = np.asarray(lrs, np.float32)
    with full_f32():
        for b in range(nb):
            emb = _prenorm(embeddings[rows[b].reshape(-1)], ca_pre_norm)
            loss = _step_loss(module(emb), r, num_anchor, num_positive, temperature,
                              contrastive_weight)
            grads = torch.autograd.grad(loss, live_params, allow_unused=True)
            _sgd(params, dict(zip(live, grads)), state.trace, float(lrs[b]), momentum,
                 weight_decay, train_mask)
            losses[b] = loss.detach()
    return state, losses


def train_contrastive_epoch_vmapped(
    state: StackedState,  # S encoders (adapter.*, optional head.*)
    embeddings: torch.Tensor,  # [N, D] shared by every row
    rows: torch.Tensor,  # [S, nb, rows_per_step, A + P + N] int64, each row's shuffle
    lrs: torch.Tensor,  # [nb] shared or [S, nb] per row, on the device
    train_mask: Mapping[str, float],
    *,
    num_anchor: int,
    num_positive: int,
    num_negative: int,
    temperature: float = 0.1,
    contrastive_weight: float = 0.1,
    ca_pre_norm: bool = True,
    momentum: float = 0.9,
    weight_decay: float = 5e-5,
) -> Tuple[StackedState, torch.Tensor]:
    """S rows' SupCon epochs at once; returns the state and the ``[S, nb]``
    step losses on the device.  Row ``i`` computes what
    :func:`train_contrastive_epoch` computes on its own rows; the rows'
    epochs have one length (the rows come from one set of pools)."""
    live, _ = _live(train_mask)
    params = state.params
    live_params = [params[n] for n in live]
    S, nb, r = rows.shape[:3]
    losses = torch.zeros(S, nb, dtype=torch.float32, device=embeddings.device)
    neg_lrs = -(lrs if lrs.dim() == 2 else lrs.expand(S, -1))
    with full_f32():
        for b in range(nb):
            emb = _prenorm(embeddings[rows[:, b].reshape(S, -1)], ca_pre_norm)
            loss = _step_loss(stacked_encoder(params, state.buffers, emb), r, num_anchor,
                              num_positive, temperature, contrastive_weight)
            grads = torch.autograd.grad(loss.sum(), live_params, allow_unused=True)
            _sgd_stacked(params, grads, state.trace, neg_lrs[:, b], momentum, weight_decay,
                         live, None)
            losses[:, b] = loss.detach()
    return state, losses
