"""Group-structured dataset metadata as flat numpy arrays.

Parity surface: the shared structure of the reference's torch Datasets
(data/waterbirds.py:23-75, data/celeba.py:15-68, data/*_embeddings*.py):
per-sample class ``y``, spurious attribute ``place``, derived
``group = y * n_places + place``, split id, filename, plus group counts and
train-distribution group ratios used for the weighted mean accuracy
(final_main.py:707-714).

The rebuild keeps this as one immutable array-of-columns table: no
``__getitem__`` Python hot path — batches are gathered with numpy fancy
indexing and shipped to the device whole.  This is the PyTorch port's copy
of the JAX package's module (the port imports nothing of that package).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

SPLIT_IDS: Dict[str, int] = {"train": 0, "val": 1, "test": 2}


@dataclasses.dataclass(frozen=True)
class GroupTable:
    """Columnar metadata for one split (or a subset of one)."""

    filenames: np.ndarray  # [N] unicode
    y: np.ndarray  # [N] int32 class labels
    place: np.ndarray  # [N] int32 spurious attribute
    split: np.ndarray  # [N] int32 split ids
    n_classes: int = 2
    n_places: int = 2

    def __post_init__(self):
        assert len(self.filenames) == len(self.y) == len(self.place) == len(self.split)

    def __len__(self) -> int:
        return len(self.y)

    @property
    def n_groups(self) -> int:
        return self.n_classes * self.n_places

    @property
    def group(self) -> np.ndarray:
        """group = y * n_places + place (reference waterbirds.py:37)."""
        return (self.y * self.n_places + self.place).astype(np.int32)

    @property
    def group_counts(self) -> np.ndarray:
        return np.bincount(self.group, minlength=self.n_groups).astype(np.float32)

    @property
    def group_ratio(self) -> np.ndarray:
        return self.group_counts / max(len(self), 1)

    def take(self, indices: np.ndarray) -> "GroupTable":
        return GroupTable(
            filenames=self.filenames[indices],
            y=self.y[indices],
            place=self.place[indices],
            split=self.split[indices],
            n_classes=self.n_classes,
            n_places=self.n_places,
        )

    def labels(self, target: str) -> np.ndarray:
        """Training-target selector: class / spurious / group
        (final_main.py train_target semantics)."""
        return {
            "class": self.y,
            "spurious": self.place,
            "group": self.group,
        }[target].astype(np.int32)


def group_to_y_p(g: int, n_places: int = 2):
    """group id -> (class, place) (reference final_main.py:409-412)."""
    return g // n_places, g % n_places


def _read_csv_columns(path: str, wanted):
    """Tiny dependency-light CSV reader returning {column: list[str]}."""
    import csv

    out = {w: [] for w in wanted}
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None:
            # empty/truncated file: DictReader yields None fieldnames and
            # the membership test below would raise an opaque TypeError
            raise ValueError(f"{path}: empty CSV (no header row)")
        missing = [w for w in wanted if w not in reader.fieldnames]
        if missing:
            raise ValueError(f"{path}: missing columns {missing} (has {reader.fieldnames})")
        for row in reader:
            for w in wanted:
                out[w].append(row[w])
    return out


def load_waterbirds_metadata(
    data_dir: str, split: Optional[str] = None
) -> GroupTable:
    """Parse ``metadata.csv`` (Group-DRO layout: img_filename, y, split,
    place) — reference data/waterbirds.py:30-44."""
    cols = _read_csv_columns(
        os.path.join(data_dir, "metadata.csv"), ("img_filename", "y", "split", "place")
    )
    table = GroupTable(
        filenames=np.asarray(cols["img_filename"]),
        y=np.asarray(cols["y"], np.int32),
        place=np.asarray(cols["place"], np.int32),
        split=np.asarray(cols["split"], np.int32),
    )
    if split is not None:
        table = table.take(np.where(table.split == SPLIT_IDS[split])[0])
    return table


def load_celeba_metadata(data_dir: str, split: Optional[str] = None) -> GroupTable:
    """Parse ``list_attr_celeba.csv`` + ``list_eval_partition.csv``:
    y = Blond_Hair, place = Male, with the -1 -> 0 remap
    (reference data/celeba.py:22-30)."""
    attrs = _read_csv_columns(
        os.path.join(data_dir, "list_attr_celeba.csv"),
        ("image_id", "Blond_Hair", "Male"),
    )
    parts = _read_csv_columns(
        os.path.join(data_dir, "list_eval_partition.csv"), ("image_id", "partition")
    )
    if attrs["image_id"] != parts["image_id"]:
        raise ValueError("attr/partition CSVs disagree on image order")
    y = np.maximum(np.asarray(attrs["Blond_Hair"], np.int32), 0)
    place = np.maximum(np.asarray(attrs["Male"], np.int32), 0)
    table = GroupTable(
        filenames=np.asarray(attrs["image_id"]),
        y=y,
        place=place,
        split=np.asarray(parts["partition"], np.int32),
    )
    if split is not None:
        table = table.take(np.where(table.split == SPLIT_IDS[split])[0])
    return table


def load_metadata(dataset: str, data_dir: str, split: Optional[str] = None) -> GroupTable:
    if dataset == "waterbirds":
        return load_waterbirds_metadata(data_dir, split)
    if dataset == "celeba":
        return load_celeba_metadata(data_dir, split)
    raise ValueError(f"unknown dataset {dataset!r}")
