"""Mid-run checkpoint / resume (port of ``train/checkpoint.py``).

The reference only saves the best model at the END of training
(final_main.py:1112-1122) and loses everything on a crash.  The trainer
checkpoints the full training state — model parameters, BatchNorm running
statistics, SGD momentum, the MultipleAdapter state when present, the
best-model snapshot, the epoch history, and the host RNG states — and can
resume bit-exactly mid-schedule (including across the phase boundary).

Layout, as the JAX package's: ``directory/ep{epoch:05d}/`` holds the tensor
payload (``state.pt``, a ``torch.save`` of nested dicts of CPU tensors,
where the JAX package writes Orbax) and ``host_meta.json`` (the epoch, the
payload's keys, the numpy ``bit_generator.state``, the history and the
best-model scalars).  ``host_meta.json`` is written last, so a directory
without it is a half-written checkpoint.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from debiasing_multi_modal_tpu_torch.utils.trees import host_copy

PAYLOAD = "state.pt"
META = "host_meta.json"


def save_checkpoint(
    directory: str,
    epoch: int,
    payload: Dict[str, Any],
    rng: np.random.Generator,
    meta_extra: Optional[Dict[str, Any]] = None,
    keep: int = 2,
):
    """Write ``directory/ep{epoch:05d}`` and prune older checkpoints.

    ``payload`` holds nested dicts of tensors (saved with ``torch.save``);
    ``meta_extra`` holds JSON-serializable host state (epoch history,
    best-model scalars)."""
    os.makedirs(directory, exist_ok=True)
    step_dir = os.path.join(os.path.abspath(directory), f"ep{epoch:05d}")
    os.makedirs(step_dir, exist_ok=True)
    tree = {k: host_copy(v) for k, v in payload.items() if v is not None}
    torch.save(tree, os.path.join(step_dir, PAYLOAD))
    meta = {
        "epoch": epoch,
        "keys": sorted(tree),
        "rng_state": rng.bit_generator.state,
        **(meta_extra or {}),
    }
    with open(os.path.join(step_dir, META), "w") as f:
        json.dump(meta, f)

    all_dirs = sorted(
        d for d in os.listdir(directory)
        if d.startswith("ep") and os.path.isdir(os.path.join(directory, d))
    )
    # prune by COMPLETE checkpoints only: counting half-written dirs (crash
    # between the payload save and host_meta.json) toward `keep` would
    # delete complete checkpoints while the corrupt dirs survive.
    # Incomplete dirs older than the one just written are junk; remove them.
    complete = [
        d for d in all_dirs if os.path.isfile(os.path.join(directory, d, META))
    ]
    doomed = set(complete[:-keep])
    doomed.update(d for d in all_dirs if d not in complete and d != f"ep{epoch:05d}")
    for old in doomed:
        shutil.rmtree(os.path.join(directory, old))


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("ep") and os.path.isdir(os.path.join(directory, d))
    )
    # a crash between the payload save and the host_meta.json write leaves a
    # half-written step dir; fall back to the newest COMPLETE checkpoint
    for step in reversed(steps):
        if os.path.isfile(os.path.join(directory, step, META)):
            return os.path.join(directory, step)
    return None


def load_checkpoint(step_dir: str):
    """Returns (epoch, payload tree of CPU tensors, full host meta dict).
    The payload holds tensors only, so it loads with ``weights_only=True``."""
    tree = torch.load(os.path.join(step_dir, PAYLOAD), map_location="cpu",
                      weights_only=True)
    with open(os.path.join(step_dir, META)) as f:
        meta = json.load(f)
    return meta["epoch"], tree, meta


def restore_rng(rng_state) -> np.random.Generator:
    rng = np.random.default_rng(0)
    rng.bit_generator.state = rng_state
    return rng
