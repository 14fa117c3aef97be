"""Split-panel embedding scatter plots (a copy of the JAX package's
``viz/plots.py``; matplotlib is imported by each figure, not by the module;
reference ``plot_umap_all``,
visualizer.py:411-638): one panel per split, colored by group / class /
spurious / prediction, with group-centroid markers and optional text-prompt
annotations anchored at their nearest image embeddings.

``plot_splits`` fits each panel independently (the reference's per-split
``VisRep``/plot_umap, :311-408); ``plot_splits_joint`` is the ``VisRepAll``
figure: one shared projection, 2x3 grid (scatter row over a per-split stats
row), arrow-annotated text prompts, star group centroids, and a 3-D variant
(the reference's Annotation3D/Arrow3D machinery, :716-771, realized with
matplotlib's native 3-D text + line segments)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from debiasing_multi_modal_tpu_torch.templates import get_prompts
from debiasing_multi_modal_tpu_torch.viz.analysis import (
    joint_projection,
    nearest_sample,
    project_2d,
)

# the reference's discrete palettes (plot_umap_all:528-534)
_COLORS2 = ("midnightblue", "red")
_COLORS4 = ("midnightblue", "darkorange", "red", "royalblue")

_LABEL_KEYS = ("group", "target", "spurious", "prediction")


def _legend_labels(dataset: str):
    p = get_prompts(dataset)
    return {
        "target": dict(enumerate(p.classes)),
        "spurious": dict(enumerate(p.spurious_attributes)),
        "group": dict(enumerate(p.group_attributes)),
        "prediction": {i: f"pred: {c}" for i, c in enumerate(p.classes)},
    }


def plot_splits(
    split_embeddings: Dict[str, np.ndarray],
    split_labels: Dict[str, Dict[str, np.ndarray]],
    dataset: str = "waterbirds",
    color_by: str = "group",
    method: str = "auto",
    text_embeddings: Optional[np.ndarray] = None,  # [C, D] for annotations
    text_names: Optional[Sequence[str]] = None,
    out_path: Optional[str] = None,
    seed: int = 42,
):
    """Render one panel per split; returns the matplotlib figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(split_embeddings)
    legend = _legend_labels(dataset)[color_by]
    fig, axes = plt.subplots(1, len(names), figsize=(6 * len(names), 5), squeeze=False)

    for ax, name in zip(axes[0], names):
        emb = split_embeddings[name]
        labels = np.asarray(split_labels[name][color_by])
        pts = project_2d(emb, method=method, seed=seed)
        for value, text in legend.items():
            m = labels == value
            if not m.any():
                continue
            # one explicit cycle color per group: an unlabeled star scatter
            # would ADVANCE the color cycle, drawing every centroid in the
            # NEXT group's color
            color = f"C{int(value) % 10}"
            ax.scatter(pts[m, 0], pts[m, 1], s=6, alpha=0.5, label=text,
                       color=color)
            centroid = pts[m].mean(axis=0)
            ax.scatter(*centroid, s=120, marker="*", color=color,
                       edgecolor="black", zorder=5)
        if text_embeddings is not None:
            for c, temb in enumerate(text_embeddings):
                anchor = nearest_sample(emb, temb)
                tname = text_names[c] if text_names else f"text {c}"
                ax.annotate(
                    tname,
                    pts[anchor],
                    fontsize=8,
                    fontweight="bold",
                    bbox=dict(boxstyle="round", fc="white", alpha=0.7),
                )
        ax.set_title(name)
        ax.legend(fontsize=7, loc="best")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
    return fig


def plot_splits_joint(
    split_embeddings: Dict[str, np.ndarray],
    split_labels: Dict[str, Dict[str, np.ndarray]],
    dataset: str = "waterbirds",
    color_by: str = "group",
    method: str = "auto",
    text_embeddings: Optional[np.ndarray] = None,  # [C, D]
    text_names: Optional[Sequence[str]] = None,
    stats_tables: Optional[Dict[str, Dict[str, Sequence[float]]]] = None,
    out_path: Optional[str] = None,
    seed: int = 42,
    num_nn_text: int = 10,
    n_components: int = 2,
    title: Optional[str] = None,
):
    """The reference-style joint figure (plot_umap_all, visualizer.py:411-638).

    One projection fitted over all splits together; panels share the reduced
    space.  ``stats_tables`` maps split -> {row_label: [values...]} rendered
    under each panel (the Acc./Div./Centr.Norm. tables of VisRepAll:200-225).
    ``n_components=3`` renders 3-D panels with annotated prompts (:716-771).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    assert n_components in (2, 3)
    names = list(split_embeddings)
    legend = _legend_labels(dataset)[color_by]
    groups = {n: np.asarray(split_labels[n]["group"]) for n in names}
    proj = joint_projection(
        split_embeddings, split_groups=groups, text_embeddings=text_embeddings,
        method=method, seed=seed, num_nn_text=num_nn_text,
        n_components=n_components,
    )
    all_pts = np.concatenate([proj["splits"][n] for n in names])
    origin = all_pts.mean(axis=0)

    n_rows = 2 if stats_tables else 1
    subplot_kw = {"projection": "3d"} if n_components == 3 else {}
    fig, axs = plt.subplots(
        n_rows, len(names), figsize=(8 * len(names), 8 if stats_tables else 6),
        squeeze=False, subplot_kw=subplot_kw,
        gridspec_kw={"height_ratios": [2.5, 1]} if stats_tables else {},
    )
    palette = _COLORS4 if len(legend) == 4 else _COLORS2

    for idx, name in enumerate(names):
        ax = axs[0][idx]
        pts = proj["splits"][name]
        labels = np.asarray(split_labels[name][color_by])
        for value, text in legend.items():
            m = labels == value
            if not m.any():
                continue
            ax.scatter(*pts[m].T, s=2.0, alpha=0.9,
                       color=palette[int(value) % len(palette)], label=text)
        # group centroids from the jointly-projected mean rows (row 0 = full)
        means = proj["group_means"][name]
        for g in range(1, len(means)):
            ax.scatter(*means[g], s=140, marker="*",
                       color=palette[(g - 1) % len(palette)],
                       edgecolor="black", zorder=5)
        if proj["text"] is not None:
            for c, anchor in enumerate(proj["text"]):
                tname = text_names[c] if text_names else f"text {c}"
                tname = tname.split("a photo of ")[-1]  # remove_prefix
                if n_components == 2:
                    ax.annotate(
                        f'"{tname}"', xytext=anchor, xy=origin,
                        arrowprops=dict(arrowstyle="<|-"),
                        bbox=dict(boxstyle="round4", fc="w", alpha=0.8),
                    )
                else:
                    # 3-D: native text + arrow segment toward the origin mean
                    ax.text(*anchor, f'"{tname}"', fontsize=8,
                            bbox=dict(boxstyle="round4", fc="w", alpha=0.8))
                    seg = np.stack([anchor, origin])
                    ax.plot(*seg.T, color="black", linewidth=0.8)
        ax.set_title(f"{name.capitalize()} set")
        ax.legend(fontsize=7, loc="best", markerscale=4)

        if stats_tables:
            tax = axs[1][idx]
            if n_components == 3:
                tax.set_axis_off()
            tax.axis("off")
            table = stats_tables.get(name)
            if table:
                rows = list(table)
                cells = [[f"{v:.3f}" for v in table[r]] for r in rows]
                ncol = max(len(c) for c in cells)
                cols = ["Avg.", "Worst"] + [f"group{g}" for g in range(ncol - 2)]
                tax.table(cellText=cells, rowLabels=rows,
                          colLabels=cols[:ncol], loc="center")

    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
    return fig, proj


def split_stats_table(
    embeddings: np.ndarray,
    groups: np.ndarray,
    group_accs: Optional[Dict[str, float]] = None,
    n_groups: int = 4,
) -> Dict[str, Sequence[float]]:
    """The per-split stats block of VisRepAll (visualizer.py:200-225):
    rows Acc. (mean, worst, per group), Div. (mean pairwise distance; full
    first, 0 in the Worst slot), Centr. Norm. (mean-vector norms)."""
    from debiasing_multi_modal_tpu_torch.viz.analysis import (
        group_stats, mean_pairwise_distance,
    )

    st = group_stats(embeddings, groups, n_groups=n_groups)
    full_norm = float(np.linalg.norm(embeddings.mean(axis=0)))
    full_div = mean_pairwise_distance(embeddings)
    table = {}
    if group_accs:
        table["Acc."] = [
            group_accs.get("mean_acc", float("nan")),
            group_accs.get("worst_acc", float("nan")),
        ] + [group_accs.get(f"acc_{g // 2}_{g % 2}", float("nan")) for g in range(n_groups)]
    table["Div."] = [full_div, 0.0] + [
        st[g]["mean_pairwise_dist"] for g in range(n_groups)
    ]
    table["Centr. Norm."] = [full_norm, 0.0] + [
        st[g]["mean_norm"] for g in range(n_groups)
    ]
    return table
