"""Prompt templates and dataset label vocabularies.

Parity surface: reference ``classic_templates.py``,
``classic_waterbirds_templates.py`` (:1-9) and ``classic_celeba_templates.py``
(:1-7) — a single ``'a photo of a {}.'`` template plus per-dataset class /
spurious-attribute / group-attribute phrase lists.

Rather than three loose module-level globals, the rebuild keys everything by
dataset name in a small registry so entry points can be dataset-generic.  The
PyTorch port keeps this copy of the JAX package's registry so that it
imports nothing of that package.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

TEMPLATES: List[str] = ["a photo of a {}."]


@dataclass(frozen=True)
class DatasetPrompts:
    """Label phrase sets for one dataset (class / spurious / 4-way group)."""

    name: str
    classes: Tuple[str, ...]
    spurious_attributes: Tuple[str, ...]
    group_attributes: Tuple[str, ...]
    templates: Tuple[str, ...] = tuple(TEMPLATES)

    def prompts(self, kind: str) -> List[str]:
        """Fully templated prompt strings for ``kind`` in {class,spurious,group}."""
        phrases = {
            "class": self.classes,
            "spurious": self.spurious_attributes,
            "group": self.group_attributes,
        }[kind]
        # The reference averages over its (single-element) template set per
        # phrase (clip_inference.py:59-65); with one template this is a direct
        # format.  We keep the per-phrase x per-template structure.
        return [t.format(p) for p in phrases for t in self.templates]

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    @property
    def n_groups(self) -> int:
        return len(self.group_attributes)


WATERBIRDS = DatasetPrompts(
    name="waterbirds",
    classes=("landbird", "waterbird"),
    spurious_attributes=("land-background", "water-background"),
    group_attributes=(
        "landbird on land-background",
        "landbird on water-background",
        "waterbird on land-background",
        "waterbird on water-background",
    ),
)

CELEBA = DatasetPrompts(
    name="celeba",
    classes=("not blond hair", "blond hair"),
    spurious_attributes=("female", "male"),
    group_attributes=(
        "female with not blond hair",
        "male with not blond hair",
        "female with blond hair",
        "male with blond hair",
    ),
)

REGISTRY: Dict[str, DatasetPrompts] = {
    "waterbirds": WATERBIRDS,
    "celeba": CELEBA,
}


def get_prompts(dataset: str) -> DatasetPrompts:
    try:
        return REGISTRY[dataset]
    except KeyError:
        raise ValueError(
            f"unknown dataset {dataset!r}; known: {sorted(REGISTRY)}"
        ) from None
