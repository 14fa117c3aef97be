"""Small nested-container utilities shared by the trainer and checkpoints
(the port's counterpart of ``utils/trees.py``)."""

from __future__ import annotations

import torch


def host_copy(tree):
    """Tensors in nested dicts, lists and tuples -> detached CPU tensors (one
    transfer per tensor); other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree
