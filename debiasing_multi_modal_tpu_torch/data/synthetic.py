"""Synthetic group-structured fixtures for tests and benchmarks (the port's
numpy copy of ``data/synthetic.py``: one ``SyntheticSpec`` gives both
packages the same arrays).

The real Waterbirds/CelebA images and the OpenAI checkpoints are not shipped
with this repo; the synthetic generator reproduces the *structure* the
pipeline cares about — embeddings whose class signal is entangled with a
spurious direction, with a skewed group distribution — so the two-phase
debiasing trainer exhibits the same qualitative behavior it does on the real
data (ERM fits the spurious feature; balanced phase-2 training recovers
worst-group accuracy).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from debiasing_multi_modal_tpu_torch.data.embeddings_store import EmbeddingTable
from debiasing_multi_modal_tpu_torch.data.groups import GroupTable


@dataclasses.dataclass
class SyntheticSpec:
    dim: int = 64
    n_train: int = 512
    n_val: int = 256
    n_test: int = 256
    spurious_corr: float = 0.95  # P(place == y) on the train split
    class_signal: float = 1.0
    spurious_signal: float = 2.0  # spurious direction is the *stronger* cue
    noise: float = 0.8
    seed: int = 0


def _make_split(
    rng: np.random.Generator,
    n: int,
    split_id: int,
    spec: SyntheticSpec,
    class_dir: np.ndarray,
    spur_dir: np.ndarray,
    balanced: bool,
) -> Tuple[GroupTable, np.ndarray]:
    y = rng.integers(0, 2, n).astype(np.int32)
    if balanced:
        place = rng.integers(0, 2, n).astype(np.int32)
    else:
        agree = rng.random(n) < spec.spurious_corr
        place = np.where(agree, y, 1 - y).astype(np.int32)
    signs_y = 2.0 * y - 1.0
    signs_p = 2.0 * place - 1.0
    emb = (
        signs_y[:, None] * spec.class_signal * class_dir[None, :]
        + signs_p[:, None] * spec.spurious_signal * spur_dir[None, :]
        + spec.noise * rng.standard_normal((n, spec.dim))
    ).astype(np.float32)
    names = np.asarray([f"s{split_id}_{i:06d}.jpg" for i in range(n)])
    table = GroupTable(
        filenames=names,
        y=y,
        place=place,
        split=np.full(n, split_id, np.int32),
    )
    return table, emb


def make_synthetic_dataset(spec: SyntheticSpec = SyntheticSpec()):
    """Returns (meta_all, EmbeddingTable, text_class [D,2], text_group [D,4],
    text_spurious [D,2])."""
    rng = np.random.default_rng(spec.seed)
    class_dir = rng.standard_normal(spec.dim)
    class_dir /= np.linalg.norm(class_dir)
    spur_dir = rng.standard_normal(spec.dim)
    spur_dir -= class_dir * (spur_dir @ class_dir)
    spur_dir /= np.linalg.norm(spur_dir)

    tables, embs = [], []
    for split_id, n, balanced in (
        (0, spec.n_train, False),
        (1, spec.n_val, True),
        (2, spec.n_test, True),
    ):
        t, e = _make_split(rng, n, split_id, spec, class_dir, spur_dir, balanced)
        tables.append(t)
        embs.append(e)

    meta = GroupTable(
        filenames=np.concatenate([t.filenames for t in tables]),
        y=np.concatenate([t.y for t in tables]),
        place=np.concatenate([t.place for t in tables]),
        split=np.concatenate([t.split for t in tables]),
    )
    embeddings = np.concatenate(embs, axis=0)

    # Zero-shot text anchors: class text = ±class_dir (+ spurious leak, which
    # is what makes plain zero-shot biased), group text = combinations.
    leak = 0.4
    text_class = np.stack(
        [
            -spec.class_signal * class_dir - leak * spur_dir,
            spec.class_signal * class_dir + leak * spur_dir,
        ],
        axis=1,
    ).astype(np.float32)
    text_spurious = np.stack([-spur_dir, spur_dir], axis=1).astype(np.float32)
    text_group = np.stack(
        [
            -class_dir - spur_dir,
            -class_dir + spur_dir,
            class_dir - spur_dir,
            class_dir + spur_dir,
        ],
        axis=1,
    ).astype(np.float32)

    # zero-shot predictions from the class anchors (normalized cosine argmax)
    def _norm(m, axis):
        return m / np.linalg.norm(m, axis=axis, keepdims=True)

    logits = _norm(embeddings, 1) @ _norm(text_class, 0)
    y_pred = logits.argmax(1).astype(np.int32)

    table = EmbeddingTable(
        filenames=meta.filenames,
        y=meta.y,
        place=meta.place,
        group=meta.group,
        split=meta.split,
        y_pred=y_pred,
        embeddings=embeddings,
    )
    return meta, table, text_class, text_group, text_spurious
