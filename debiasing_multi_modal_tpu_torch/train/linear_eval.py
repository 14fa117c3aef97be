"""Linear evaluation of frozen representations, SupCon protocol (port of
``train/linear_eval.py``).

Parity surface: reference ``workspace/jinsu/lin_eval.py`` — train a linear
classifier on features from a frozen encoder, SGD + the same step-decay/
warmup schedules, top-1 accuracy tracking.

Works on any feature source: cached CLIP embeddings, adapter outputs, or
the plain ResNet encoder (``models/resnet_plain.py``).  An epoch is an eager
loop over a batch plan resident on the device (``data/samplers.epoch_plan``,
the JAX package's numpy plans, uploaded pinned and non-blocking), with the
Stage-B step's pieces: ``train/losses.masked_cross_entropy``,
``train/steps._sgd`` and the learning rates of
``train/schedules.epoch_batch_lrs`` as host floats.  The accuracy stays on
the device until the run ends, so the host never waits inside an epoch.
The products run at full f32 (``utils/platform.full_f32``, no TF32).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from debiasing_multi_modal_tpu_torch.train.losses import masked_cross_entropy
from debiasing_multi_modal_tpu_torch.train.steps import _sgd, ones_mask
from debiasing_multi_modal_tpu_torch.utils.platform import DeviceLike, full_f32, resolve_device
from debiasing_multi_modal_tpu_torch.utils.staging import upload


def _linear_epoch(params: Dict[str, torch.Tensor], trace: Dict[str, torch.Tensor],
                  feats: torch.Tensor, labels: torch.Tensor, idx: torch.Tensor,
                  mask: torch.Tensor, lrs: np.ndarray, *, momentum: float,
                  weight_decay: float) -> torch.Tensor:
    """One epoch of SGD on ``params`` in place; returns the epoch's training
    accuracy as a device scalar."""
    mask_tree = ones_mask(params)
    names = list(params)
    correct = torch.zeros((), dtype=torch.int64, device=feats.device)
    total = torch.zeros((), dtype=torch.int64, device=feats.device)
    for b in range(idx.shape[0]):
        x, y, b_mask = feats[idx[b]], labels[idx[b]], mask[b]
        logits = x @ params["w"] + params["b"]
        loss = masked_cross_entropy(logits, y, b_mask)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        with torch.no_grad():
            _sgd(params, dict(zip(names, grads)), trace, float(lrs[b]), momentum,
                 weight_decay, mask_tree)
            correct += ((logits.argmax(-1) == y) & b_mask).sum()
            total += b_mask.sum()
    return correct.float() / total.clamp_min(1).float()


def linear_probe(
    features: np.ndarray,
    labels: np.ndarray,
    num_classes: int = 2,
    epochs: int = 10,
    batch_size: int = 256,
    learning_rate: float = 0.1,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    seed: int = 42,
    lr_decay_epochs: Tuple[int, ...] = (),
    lr_decay_rate: float = 0.1,
    cosine: bool = False,
    warm: bool = False,
    device: DeviceLike = None,
) -> Tuple[dict, float]:
    """Train a linear head on frozen features; returns (params as numpy,
    the last epoch's training accuracy).  Runs on ``device`` (``cuda``
    unless the CPU is asked for).

    The reference schedules (``adjust_learning_rate`` step/cosine decay +
    ``warmup_learning_rate``) apply when their knobs are set; the defaults
    train at constant lr."""
    from debiasing_multi_modal_tpu_torch.data.samplers import epoch_plan
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
    from debiasing_multi_modal_tpu_torch.train.schedules import epoch_batch_lrs

    dev = resolve_device(device)
    sched_cfg = TrainConfig(
        tl_method="linear_probing", epochs=epochs,
        learning_rate=learning_rate,
        lr_decay_epochs=tuple(lr_decay_epochs) or (epochs + 1,),
        lr_decay_rate=lr_decay_rate, cosine=cosine,
        warm=warm,  # warm_epochs/warmup_from/to derive per the reference
        batch_size=batch_size, input_dim=int(features.shape[1]),
    )
    rng = np.random.default_rng(seed)
    d = features.shape[1]
    params = {"w": torch.zeros(d, num_classes, device=dev, requires_grad=True),
              "b": torch.zeros(num_classes, device=dev, requires_grad=True)}
    trace = {k: torch.zeros_like(v) for k, v in params.items()}
    feats = upload(np.asarray(features, np.float32), dev)
    labs = upload(np.asarray(labels, np.int64), dev)
    acc = torch.zeros((), device=dev)
    with full_f32():
        for epoch in range(1, epochs + 1):
            plan = epoch_plan(len(features), batch_size, shuffle=True, rng=rng)
            lrs = epoch_batch_lrs(sched_cfg, epoch, plan.num_batches, phase=1)
            acc = _linear_epoch(params, trace, feats, labs,
                                upload(plan.indices.astype(np.int64), dev),
                                upload(plan.mask, dev), lrs,
                                momentum=momentum, weight_decay=weight_decay)
    return {k: v.detach().cpu().numpy() for k, v in params.items()}, float(acc)


def evaluate_linear(params, features: np.ndarray, labels: np.ndarray) -> float:
    logits = features @ np.asarray(params["w"]) + np.asarray(params["b"])
    return float((logits.argmax(-1) == labels).mean())
