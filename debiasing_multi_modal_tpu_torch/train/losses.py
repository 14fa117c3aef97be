"""Losses (port of ``train/losses.py``): the masked cross-entropy.

Parity surface: torch ``CrossEntropyLoss`` (mean reduction) used throughout
``final_main.py``, with the padded rows of a fixed-shape batch left out of
the mean.  ``supcon_loss`` waits for the contrastive-adapter slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid rows (padded rows excluded from the mean)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if mask is None:
        return nll.mean()
    m = mask.to(torch.float32)
    return (nll * m).sum() / m.sum().clamp_min(1.0)
