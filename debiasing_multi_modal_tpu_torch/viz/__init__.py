"""Embedding-space analysis and plots (port of ``viz/``)."""

from debiasing_multi_modal_tpu_torch.viz.analysis import (  # noqa: F401
    adapted_embeddings,
    group_stats,
    project_2d,
)
from debiasing_multi_modal_tpu_torch.viz.plots import plot_splits  # noqa: F401
