"""Fold frozen BatchNorms into adjacent convolutions (port of
``weights/fold.py``, the inference transform behind ``fuse_bn``).

The CLIP ResNet tower is a frozen feature extractor, so every BatchNorm is an
affine map of its running statistics:

    bn(conv(x)) = conv(x) * inv + shift = conv_with(weight * inv, bias=shift)(x)

with ``inv = weight / sqrt(running_var + eps)`` and
``shift = bias - running_mean * inv``, both in float64, the folded weight
and bias cast to f32 (as the JAX ``_fold_pair`` does, so the two folds agree
bit for bit).  :func:`fold_resnet_bn` rewrites an OpenAI-layout state dict
into the parameters of the ``fuse_bn=True`` model (``models/resnet.py``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np

_EPS = 1e-5
_BN_FIELDS = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")
# a visual BatchNorm prefix -> the conv it follows: the stem's and each
# block's bn{i} -> conv{i}, a block's downsample.1 -> downsample.0
_BN = re.compile(r"(visual\.(?:layer\d+\.\d+\.)?)(bn(\d)|downsample\.1)")


def _conv_of(bn_prefix: str) -> str:
    m = _BN.fullmatch(bn_prefix)
    return m.group(1) + (f"conv{m.group(3)}" if m.group(3) else "downsample.0")


def fold_resnet_bn(state_dict: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """An OpenAI-layout ModifiedResNet CLIP state dict -> the state dict of
    the ``fuse_bn=True`` model: each conv weight scaled per output channel,
    with a ``.bias``; every visual BatchNorm key gone.  Other keys (the text
    tower, the attention pool) pass through untouched.  Raises
    ``ValueError`` if the dict has no visual BatchNorms (a ViT)."""
    bns = sorted({k[: -len(".running_var")] for k in state_dict
                  if k.endswith(".running_var") and _BN.fullmatch(k[: -len(".running_var")])})
    if not bns:
        raise ValueError("no visual BatchNorm statistics to fold (ViT tower?)")
    folded: Dict[str, np.ndarray] = {}
    for bn in bns:
        conv = _conv_of(bn)
        inv = np.asarray(state_dict[f"{bn}.weight"], np.float64) / np.sqrt(
            np.asarray(state_dict[f"{bn}.running_var"], np.float64) + _EPS)
        shift = (np.asarray(state_dict[f"{bn}.bias"], np.float64)
                 - np.asarray(state_dict[f"{bn}.running_mean"], np.float64) * inv)
        weight = np.asarray(state_dict[f"{conv}.weight"], np.float64)  # [O, I, kh, kw]
        folded[f"{conv}.weight"] = (weight * inv[:, None, None, None]).astype(np.float32)
        folded[f"{conv}.bias"] = shift.astype(np.float32)
    dropped = {f"{bn}.{field}" for bn in bns for field in _BN_FIELDS}
    out: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        if key in dropped:
            continue
        out[key] = folded.pop(key) if key in folded else value
        bias = key[: -len(".weight")] + ".bias" if key.endswith(".weight") else None
        if bias in folded:
            out[bias] = folded.pop(bias)
    return out
