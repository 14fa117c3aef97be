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
- ``CAEncoder``: the contrastive loss path's encoder (the working notebook's
  ``forward_ca``): the adapter, optionally followed by a linear projection
  head.  Keys ``adapter.layers.*`` and ``head.*``.

BatchNorm follows torch ``BatchNorm1d`` semantics (biased variance to
normalize, unbiased for the running update, momentum 0.1) with a
row-validity mask, so the padded rows of a fixed-shape batch leave the
statistics untouched (:class:`MaskedBatchNorm`).  Training or evaluation is
the module's ``train()`` / ``eval()`` mode.  Everything runs in f32; a
module and inputs in float64 stay in float64 (``utils/platform.at_least_f32``,
for the dry run's identity check).  The
JAX package's ``Precision.HIGHEST`` is set per stage, not per product: the
callers (``train/steps.py``'s epochs, ``train/loop.zero_shot_results``) run
under ``utils/platform.full_f32``, so the products never fall to TF32 on
the card.

The stacked sweep (sweep/vmap_loop.py) trains S classifiers of one kind at
once: :func:`stacked_logits` and :func:`stacked_encoder` are the same
forwards over state dicts whose tensors carry a leading row axis, with the
products as ``torch.baddbmm`` and one BatchNorm statistic per row.

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

from debiasing_multi_modal_tpu_torch.utils.platform import at_least_f32


class _UndrawnLinear(nn.Linear):
    """An ``nn.Linear`` whose constructor leaves its parameters uninitialised,
    as ``nn.utils.skip_init`` does, without that function's trip through the
    meta device (a tenth of its host time): :func:`_linear` draws them."""

    def reset_parameters(self) -> None:
        pass


def _linear(fan_in: int, fan_out: int, generator: Optional[torch.Generator]) -> nn.Linear:
    """An ``nn.Linear`` with the torch default distribution drawn from
    ``generator`` (torch's global RNG when it is None), weight then bias."""
    layer = _UndrawnLinear(fan_in, fan_out)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def _group_sum(group):
    """The sum over ``group``'s ranks (identity without a group)."""
    if group is None:
        return lambda t: t
    from debiasing_multi_modal_tpu_torch.parallel.collectives import all_reduce_sum

    return lambda t: all_reduce_sum(t, group)


class MaskedBatchNorm(nn.Module):
    """torch-semantics BatchNorm1d with an optional row-validity mask.

    In training mode the batch statistics are taken over the valid rows only
    (``n = max(sum(mask), 1)``), the output is normalized with the biased
    variance, and the running averages move by ``momentum`` toward the mean
    and the unbiased variance ``var * n / max(n - 1, 1)``.  In eval mode the
    running averages normalize.  ``num_batches_tracked`` is kept for the
    reference's state-dict layout only: with a fixed momentum nothing reads
    it, so it stays 0, as the JAX package's export writes it.

    ``group`` (None unless a data-parallel epoch sets it,
    ``train/steps.py``) is the process group a batch's rows are spread
    over: the masked sums and counts are then all-reduced over it
    (``parallel/collectives.all_reduce_sum``, differentiable), so the
    statistics, the running averages and the gradients are the whole
    batch's."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        self.group = None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x32 = at_least_f32(x)
        if self.training:
            total = _group_sum(self.group)
            if mask is None and self.group is None:
                n = float(x.shape[0])
                mean = x32.mean(0)
                var = ((x32 - mean) ** 2).mean(0)
                bessel = max(n - 1.0, 1.0)
            else:
                m = (torch.ones(x.shape[0], device=x.device) if mask is None
                     else mask.to(torch.float32))[:, None]
                n = total(m.sum()).clamp_min(1.0)
                mean = total((x32 * m).sum(0)) / n
                var = total((((x32 - mean) ** 2) * m).sum(0)) / n
                bessel = (n - 1.0).clamp_min(1.0)
            with torch.no_grad():
                unbiased = var * n / bessel
                mom = self.momentum
                self.running_mean.copy_((1 - mom) * self.running_mean + mom * mean)
                self.running_var.copy_((1 - mom) * self.running_var + mom * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * at_least_f32(self.weight)
        out = (x32 - mean) * inv + at_least_f32(self.bias)
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
    x32 = at_least_f32(x)
    return x32 / torch.linalg.vector_norm(x32, dim=-1, keepdim=True)


def _col_normalize(text: torch.Tensor) -> torch.Tensor:
    t32 = at_least_f32(text)
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


class CAEncoder(nn.Module):
    """The adapter plus the notebook's optional contrastive projection head.

    Reference parity: the working contrastive-adapter flow builds
    ``CustomCLIP(..., head=opt.ca_head, ca_feat_dim=opt.ca_feat_dim)`` with
    ``opt.ca_head = 'linear'`` (SupCon.ipynb cell 3:13), and its
    ``forward_ca`` projects the adapter output through
    ``nn.Linear(input_dim, ca_feat_dim)`` before normalizing (cell 0:91-95).
    The head exists only in the contrastive loss path: the CE and zero-shot
    forward uses the bare adapter.  ``adapter`` passes in the classifier's
    own adapter, so the encoder trains it in place; otherwise the generator
    draws a fresh one.  The generator draws the head after the adapter."""

    def __init__(self, input_dim: int, hidden_dim: int = 128, ca_head: Optional[str] = None,
                 ca_feat_dim: int = 128, generator: Optional[torch.Generator] = None,
                 adapter: Optional[AdapterMLP] = None):
        super().__init__()
        if ca_head not in (None, "linear"):
            raise ValueError(f"unknown ca_head {ca_head!r}")
        self.adapter = adapter if adapter is not None else AdapterMLP(input_dim, hidden_dim,
                                                                      generator)
        self.head = None if ca_head is None else _linear(input_dim, ca_feat_dim, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        feat = self.adapter(x, mask)
        return feat if self.head is None else self.head(feat)


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


# ------------------------------------------------ stacked rows (the sweep) --


def _stacked_linear(x: torch.Tensor, params, prefix: str) -> torch.Tensor:
    """``x [S, B, I]`` through S Linear layers ``weight [S, O, I]``."""
    w, b = params[prefix + "weight"], params[prefix + "bias"]
    return torch.baddbmm(b.unsqueeze(1), x, w.transpose(1, 2))


def _stacked_batchnorm(x: torch.Tensor, params, buffers, prefix: str,
                       mask: Optional[torch.Tensor], training: bool,
                       active: Optional[torch.Tensor], momentum: float = 0.1,
                       eps: float = 1e-5) -> torch.Tensor:
    """:class:`MaskedBatchNorm` over ``x [S, B, H]``, one set of statistics
    per row; ``mask [S, B]``.  A row whose ``active`` entry is False keeps
    its running statistics (its step is padding)."""
    w, b = params[prefix + "weight"], params[prefix + "bias"]
    running_mean, running_var = buffers[prefix + "running_mean"], buffers[prefix + "running_var"]
    if training:
        if mask is None:
            n = float(x.shape[1])
            mean = x.mean(1)
            var = ((x - mean.unsqueeze(1)) ** 2).mean(1)
            bessel = max(n - 1.0, 1.0)
        else:
            m = mask.to(torch.float32).unsqueeze(-1)
            n = m.sum(1).clamp_min(1.0)  # [S, 1]
            mean = (x * m).sum(1) / n
            var = (((x - mean.unsqueeze(1)) ** 2) * m).sum(1) / n
            bessel = (n - 1.0).clamp_min(1.0)
        with torch.no_grad():
            unbiased = var * n / bessel
            new_mean = (1 - momentum) * running_mean + momentum * mean
            new_var = (1 - momentum) * running_var + momentum * unbiased
            if active is not None:
                new_mean = torch.where(active.unsqueeze(-1), new_mean, running_mean)
                new_var = torch.where(active.unsqueeze(-1), new_var, running_var)
            running_mean.copy_(new_mean)
            running_var.copy_(new_var)
    else:
        mean, var = running_mean, running_var
    inv = torch.rsqrt(var + eps) * w
    return (x - mean.unsqueeze(1)) * inv.unsqueeze(1) + b.unsqueeze(1)


def _stacked_adapter(x, params, buffers, prefix, mask, training, active):
    h = _stacked_linear(x, params, prefix + "layers.0.")
    h = _stacked_batchnorm(h, params, buffers, prefix + "layers.1.", mask, training, active)
    return _stacked_linear(torch.relu(h), params, prefix + "layers.3.")


def stacked_logits(params, buffers, x: torch.Tensor, text: torch.Tensor, temperature: float,
                   mask: Optional[torch.Tensor] = None, training: bool = False,
                   active: Optional[torch.Tensor] = None,
                   ebd_weight: float = 0.5) -> torch.Tensor:
    """S classifiers' logits ``[S, B, C]`` for ``x [S, B, D]``; the kind
    (linear probe, adapter, multiple adapter) follows the state-dict keys,
    and each computes what its module's ``forward`` does."""
    if "fc.weight" in params:
        return _stacked_linear(x, params, "fc.").float()
    if "old_cls.adapter.layers.0.weight" in params:
        with torch.no_grad():
            old = _row_normalize(_stacked_adapter(x, params, buffers, "old_cls.adapter.", mask,
                                                  training, active))
        new = _row_normalize(_stacked_adapter(x, params, buffers, "new_adapter.", mask,
                                              training, active))
        return _text_product(ebd_weight * old + (1.0 - ebd_weight) * new, text, temperature)
    adapted = _stacked_adapter(x, params, buffers, "adapter.", mask, training, active)
    return zero_shot_logits(adapted, text, temperature)


def stacked_encoder(params, buffers, x: torch.Tensor) -> torch.Tensor:
    """S :class:`CAEncoder` forwards in training mode over ``x [S, B, D]``."""
    feat = _stacked_adapter(x, params, buffers, "adapter.", None, True, None)
    return _stacked_linear(feat, params, "head.") if "head.weight" in params else feat
