"""Adapter model family for embedding-space debiasing (port of
``models/adapter.py``).

Parity surface: reference ``final_main.py`` —

- ``Adapter`` (:160-174): Linear(D -> hidden) -> BatchNorm1d -> ReLU ->
  Linear(hidden -> D), no residual.  Its modules sit at ``layers.0``,
  ``layers.1`` and ``layers.3``, the reference's state-dict keys.
- ``CustomCLIP`` (:53-92): adapter -> row-L2-normalize -> product with a
  column-normalized text matrix [D, C] / temperature (0.01 default); the
  text matrix is an explicit input (class or group prompts).  Keys
  ``adapter.layers.*``.
- ``MultipleAdapter`` (:97-158): frozen old adapter (detached) and a new
  adapter, each row-normalized, blended 0.5/0.5 *before* the text product.
  Keys ``old_cls.adapter.layers.*`` and ``new_adapter.layers.*``.
- ``LinearClassifier`` (:43-49) for linear probing.  Keys ``fc.*``.

BatchNorm follows torch ``BatchNorm1d`` semantics (biased variance to
normalize, unbiased for the running update, momentum 0.1) with a
row-validity mask, so the padded rows of a fixed-shape batch leave the
statistics untouched (:class:`MaskedBatchNorm`).  Training or evaluation is
the module's ``train()`` / ``eval()`` mode.  Everything runs in f32.  The
JAX package's ``Precision.HIGHEST`` is set per stage, not per product: the
callers (``train/steps.py``'s epochs, ``train/loop.zero_shot_results``) run
under ``utils/platform.full_f32``, so the products never fall to TF32 on
the card.  The contrastive head (``CAEncoder``) is not ported yet.

Initial weights follow the reference's torch ``nn.Linear`` distribution
(weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in))), drawn on the CPU from
the ``generator`` a constructor takes, so one generator gives every device
the same weights.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def _linear(fan_in: int, fan_out: int, generator: Optional[torch.Generator]) -> nn.Linear:
    """An ``nn.Linear`` with the torch default distribution drawn from
    ``generator`` (torch's global RNG when it is None), weight then bias."""
    layer = nn.utils.skip_init(nn.Linear, fan_in, fan_out)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


class MaskedBatchNorm(nn.Module):
    """torch-semantics BatchNorm1d with an optional row-validity mask.

    In training mode the batch statistics are taken over the valid rows only
    (``n = max(sum(mask), 1)``), the output is normalized with the biased
    variance, and the running averages move by ``momentum`` toward the mean
    and the unbiased variance ``var * n / max(n - 1, 1)``.  In eval mode the
    running averages normalize.  ``num_batches_tracked`` is kept for the
    reference's state-dict layout only: with a fixed momentum nothing reads
    it, so it stays 0, as the JAX package's export writes it."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            if mask is None:
                n = float(x.shape[0])
                mean = x32.mean(0)
                var = ((x32 - mean) ** 2).mean(0)
                bessel = max(n - 1.0, 1.0)
            else:
                m = mask.to(torch.float32)[:, None]
                n = m.sum().clamp_min(1.0)
                mean = (x32 * m).sum(0) / n
                var = (((x32 - mean) ** 2) * m).sum(0) / n
                bessel = (n - 1.0).clamp_min(1.0)
            with torch.no_grad():
                unbiased = var * n / bessel
                mom = self.momentum
                self.running_mean.copy_((1 - mom) * self.running_mean + mom * mean)
                self.running_var.copy_((1 - mom) * self.running_var + mom * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight.float()
        out = (x32 - mean) * inv + self.bias.float()
        return out.to(x.dtype)


class AdapterMLP(nn.Module):
    """Linear -> BatchNorm1d -> ReLU -> Linear (no residual)."""

    def __init__(self, input_dim: int, hidden_dim: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fc1 = _linear(input_dim, hidden_dim, generator)
        fc2 = _linear(hidden_dim, input_dim, generator)
        self.layers = nn.ModuleList([fc1, MaskedBatchNorm(hidden_dim), nn.ReLU(), fc2])

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        fc1, bn, relu, fc2 = self.layers
        return fc2(relu(bn(fc1(x), mask)))


def _row_normalize(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return x32 / torch.linalg.vector_norm(x32, dim=-1, keepdim=True)


def _col_normalize(text: torch.Tensor) -> torch.Tensor:
    t32 = text.float()
    return t32 / torch.linalg.vector_norm(t32, dim=0, keepdim=True)


def _text_product(rows: torch.Tensor, text: torch.Tensor, temperature: float) -> torch.Tensor:
    return torch.matmul(rows, _col_normalize(text)) / temperature


def zero_shot_logits(features: torch.Tensor, text: torch.Tensor,
                     temperature: float) -> torch.Tensor:
    """Normalized cosine-similarity logits: the shared prediction head.

    features [B, D] (un-normalized), text [D, C] (un-normalized) -> [B, C].
    """
    return _text_product(_row_normalize(features), text, temperature)


class AdapterClassifier(nn.Module):
    """CustomCLIP equivalent: adapter + zero-shot head."""

    def __init__(self, input_dim: int, hidden_dim: int = 128, temperature: float = 0.01,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.temperature = temperature
        self.adapter = AdapterMLP(input_dim, hidden_dim, generator)

    def forward(self, features: torch.Tensor, text: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return zero_shot_logits(self.adapter(features, mask), text, self.temperature)


class MultipleAdapterClassifier(nn.Module):
    """Frozen old adapter + trainable new adapter, 0.5/0.5 blended.

    The old branch runs without a gradient (the detach at
    final_main.py:127); its parameters are also excluded from the update by
    the train loop's freeze mask (``train/steps.freeze_subtrees``).  Its
    BatchNorm follows the module's mode like the new branch's: in phase-2
    training it normalizes each reg batch with that batch's own statistics
    and keeps drifting its running averages, as the reference's torch mode
    system does; only its parameters are frozen.  The generator draws the
    old adapter's weights, then the new one's (the train loop overwrites the
    old branch with the phase-1 adapter)."""

    def __init__(self, input_dim: int, hidden_dim: int = 128, temperature: float = 0.01,
                 ebd_weight: float = 0.5, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.temperature = temperature
        self.ebd_weight = ebd_weight
        self.old_cls = AdapterClassifier(input_dim, hidden_dim, temperature, generator)
        self.new_adapter = AdapterMLP(input_dim, hidden_dim, generator)

    def forward(self, features: torch.Tensor, text: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.no_grad():
            old = _row_normalize(self.old_cls.adapter(features, mask))
        new = _row_normalize(self.new_adapter(features, mask))
        blended = self.ebd_weight * old + (1.0 - self.ebd_weight) * new
        return _text_product(blended, text, self.temperature)


class LinearClassifier(nn.Module):
    """Linear probe (reference final_main.py:43-49); ``text`` and ``mask``
    are accepted for a uniform signature with the adapters and unused."""

    def __init__(self, input_dim: int, num_classes: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = _linear(input_dim, num_classes, generator)

    def forward(self, features: torch.Tensor, text: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.fc(features).float()
