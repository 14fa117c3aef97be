"""Losses (port of ``train/losses.py``): the masked cross-entropy and the
supervised-contrastive objective.

Parity surfaces: torch ``CrossEntropyLoss`` (mean reduction) used throughout
``final_main.py``, with the padded rows of a fixed-shape batch left out of
the mean; ``SupervisedContrastiveLoss`` (demo/visualizer_supcon.py:
1522-1587) — cosine similarities / temperature against a single anchor,
max-subtracted exponentials, ``-log(exp_pos / (sum exp_pos + sum exp_neg))``
averaged over positives, here over a whole ``[R, 1 + P + N]`` batch at once.
Both take optional leading row axes (the stacked sweep's), and reduce over
the trailing ones only.
"""

from __future__ import annotations

from typing import Optional

import torch

from debiasing_multi_modal_tpu_torch.utils.platform import at_least_f32


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid rows (padded rows excluded from the mean):
    ``logits [..., B, C]`` -> ``[...]``.  ``count`` replaces the mask's own
    count of valid rows as the divisor: under data parallelism each rank
    sums its rows' CE over the whole batch's count, and the ranks' shares
    add up to the batch's mean."""
    logp = torch.log_softmax(at_least_f32(logits), dim=-1)
    nll = -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    if mask is None:
        return nll.mean(-1)
    m = mask.to(torch.float32)
    denom = m.sum(-1) if count is None else count
    return (nll * m).sum(-1) / denom.clamp_min(1.0)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def supcon_loss(
    anchor_feats: torch.Tensor,  # [..., R, D] adapted features of the anchors
    pos_feats: torch.Tensor,  # [..., R, P, D] positives per anchor row
    neg_feats: torch.Tensor,  # [..., R, N, D] negatives per anchor row
    temperature: float = 0.1,
) -> torch.Tensor:
    """Vectorized supervised-contrastive loss over R anchor rows -> ``[...]``."""
    a = _normalize(anchor_feats).unsqueeze(-2)  # [..., R, 1, D]
    pos = (a * _normalize(pos_feats)).sum(-1) / temperature  # [..., R, P]
    neg = (a * _normalize(neg_feats)).sum(-1) / temperature  # [..., R, N]
    max_pos = pos.amax(-1, keepdim=True).detach()
    denom = (torch.exp(pos - max_pos).sum(-1, keepdim=True)
             + torch.exp(neg - max_pos).sum(-1, keepdim=True))
    # (pos - max_pos) directly, NOT log(exp_pos): the exp/log round trip
    # underflows to -inf (NaN gradients) once pos - max_pos < ~-88, which
    # small cl_temperature values reach; this form is exact and cheaper
    log_probs = (pos - max_pos) - torch.log(denom)
    return (-log_probs).flatten(-2).mean(-1)
