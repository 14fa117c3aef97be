"""Embedding cache store: fast native ``.npz`` plus reference-compatible
``clip.json``.

Parity surface: the Stage A -> Stage B file boundary of the reference.
Stage A writes per-image dicts ``{y/blond, place/male, group, split,
image_embedding, y_pred}`` keyed by filename into ``clip.json``
(clip_inference.py:159-271) and per-prompt text-embedding dicts into
``clip_class.json`` / ``clip_spurious.json`` / ``clip_group.json``
(:93-106).  Stage B reads them back with pandas (waterbirds_embeddings.py:30).

The rebuild's native format is a single ``.npz`` with contiguous columns
(embeddings as one [N, D] float32 block) — loading CelebA-scale caches is
array IO instead of 200k Python dicts — while ``clip.json`` read/write is kept
for drop-in interchange with the reference pipeline.  Embeddings are stored
UN-normalized, exactly like the reference (clip_inference.py:64-66); callers
normalize at use time (final_main.py:68,77).

This is the PyTorch port's copy of the JAX package's store (the port
imports nothing of that package).  It reads and writes JSON in pure Python;
the JAX package's optional C++ accelerator (native/ebdjson) is not ported
yet.  Caches either package writes load in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np

from debiasing_multi_modal_tpu_torch.data.groups import GroupTable

# per-dataset JSON field names for (class, spurious) — reference uses
# y/place for waterbirds and blond/male for celeba
_JSON_KEYS = {
    "waterbirds": ("y", "place"),
    "celeba": ("blond", "male"),
}


@dataclasses.dataclass
class EmbeddingTable:
    """Columnar image-embedding cache (all splits together, like clip.json)."""

    filenames: np.ndarray  # [N] unicode
    y: np.ndarray  # [N] int32
    place: np.ndarray  # [N] int32
    group: np.ndarray  # [N] int32
    split: np.ndarray  # [N] int32
    y_pred: np.ndarray  # [N] int32 zero-shot predictions
    embeddings: np.ndarray  # [N, D] float32, un-normalized

    def __len__(self):
        return len(self.y)

    def index_by_filename(self) -> Dict[str, int]:
        return {fn: i for i, fn in enumerate(self.filenames)}

    def align_to(self, meta: GroupTable) -> "EmbeddingTable":
        """Reorder rows to a metadata table's filename order and cross-check
        labels — the de-facto Stage A/Stage B integration assert of the
        reference (waterbirds_embeddings.py:84-85)."""
        idx_map = self.index_by_filename()
        try:
            rows = np.asarray([idx_map[fn] for fn in meta.filenames], np.int64)
        except KeyError as e:
            raise ValueError(
                "embedding cache is missing file "
                f"{str(e.args[0])!r} listed in metadata"
            ) from None
        sub = EmbeddingTable(
            filenames=self.filenames[rows],
            y=self.y[rows],
            place=self.place[rows],
            group=self.group[rows],
            split=self.split[rows],
            y_pred=self.y_pred[rows],
            embeddings=self.embeddings[rows],
        )
        bad = np.where(
            (sub.y != meta.y) | (sub.place != meta.place) | (sub.group != meta.group)
        )[0]
        if len(bad):
            i = int(bad[0])
            raise ValueError(
                "inconsistency between metadata and embedding cache at "
                f"{meta.filenames[i]!r}: y {meta.y[i]}=={sub.y[i]} | "
                f"group {meta.group[i]}=={sub.group[i]} | "
                f"spurious {meta.place[i]}=={sub.place[i]}"
            )
        return sub


# ------------------------------------------------------------------ image IO --


def save_embeddings(
    path: str,
    table: EmbeddingTable,
    fmt: str = "npz",
    dataset: str = "waterbirds",
):
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    if fmt == "npz":
        if not path.endswith(".npz"):
            # np.savez silently appends ".npz" to suffix-less paths, so the
            # file would land somewhere the caller's path doesn't point at
            # (and a later load_embeddings(path) would misinfer fmt)
            raise ValueError(
                f"fmt='npz' requires a .npz path, got {path!r}"
            )
        np.savez(
            path,
            filenames=table.filenames,
            y=table.y,
            place=table.place,
            group=table.group,
            split=table.split,
            y_pred=table.y_pred,
            embeddings=table.embeddings.astype(np.float32),
        )
    elif fmt == "json":
        ykey, pkey = _JSON_KEYS[dataset]
        out = {}
        for i, fn in enumerate(table.filenames):
            out[str(fn)] = {
                ykey: str(int(table.y[i])),
                "group": str(int(table.group[i])),
                pkey: str(int(table.place[i])),
                "split": str(int(table.split[i])),
                "image_embedding": [float(v) for v in table.embeddings[i]],
                "y_pred": str(int(table.y_pred[i])),
            }
        with open(path, "w") as f:
            json.dump(out, f)
    else:
        raise ValueError(f"unknown format {fmt!r}")


def _load_json_python(path: str, dataset: str) -> EmbeddingTable:
    with open(path) as f:
        raw = json.load(f)
    ykey, pkey = _JSON_KEYS[dataset]
    n = len(raw)
    filenames = np.empty(n, object)
    y = np.empty(n, np.int32)
    place = np.empty(n, np.int32)
    group = np.empty(n, np.int32)
    split = np.empty(n, np.int32)
    y_pred = np.empty(n, np.int32)
    embeddings = None
    for i, (fn, rec) in enumerate(raw.items()):
        filenames[i] = fn
        y[i] = int(rec[ykey])
        place[i] = int(rec[pkey])
        group[i] = int(rec["group"])
        split[i] = int(rec["split"])
        y_pred[i] = int(rec["y_pred"])
        emb = np.asarray(rec["image_embedding"], np.float32)
        if embeddings is None:
            embeddings = np.empty((n, emb.shape[0]), np.float32)
        embeddings[i] = emb
    return EmbeddingTable(
        filenames=filenames.astype(str),
        y=y,
        place=place,
        group=group,
        split=split,
        y_pred=y_pred,
        embeddings=embeddings if embeddings is not None else np.zeros((0, 0), np.float32),
    )


def load_embeddings(
    path: str, dataset: str = "waterbirds", fmt: Optional[str] = None
) -> EmbeddingTable:
    """Load a cache; format inferred from extension unless given."""
    if fmt is None:
        fmt = "npz" if path.endswith(".npz") else "json"
    if fmt == "npz":
        with np.load(path, allow_pickle=False) as z:
            return EmbeddingTable(
                filenames=z["filenames"].astype(str),
                y=z["y"].astype(np.int32),
                place=z["place"].astype(np.int32),
                group=z["group"].astype(np.int32),
                split=z["split"].astype(np.int32),
                y_pred=z["y_pred"].astype(np.int32),
                embeddings=z["embeddings"].astype(np.float32),
            )
    return _load_json_python(path, dataset)


# ------------------------------------------------------------------- text IO --


def save_text_embeddings(path: str, prompts, embeddings: np.ndarray):
    """Write the {prompt: [D floats]} dict of clip_{class,spurious,group}.json
    (clip_inference.py:97-106).  ``embeddings`` is [C, D], un-normalized —
    ONE row per prompt string (multi-template sets must pass one
    representative prompt per pooled row, see cli/extract_main.py)."""
    prompts = list(prompts)
    if len(prompts) != len(embeddings):
        # a silent zip truncation would key the wrong phrase to the wrong
        # embedding in the reference-interchange JSON
        raise ValueError(
            f"{len(prompts)} prompts vs {len(embeddings)} embedding rows"
        )
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    out = {p: [float(v) for v in emb] for p, emb in zip(prompts, embeddings)}
    with open(path, "w") as f:
        json.dump(out, f)


def load_text_embeddings(path: str) -> np.ndarray:
    """Read a text-embedding JSON into a [D, C] float32 matrix — the
    column-stacked layout of the reference's ``get_text_embedding``
    (final_main.py:414-424)."""
    with open(path) as f:
        raw = json.load(f)
    cols = [np.asarray(v, np.float32) for v in raw.values()]
    return np.stack(cols, axis=1)
