#!/usr/bin/env python
"""Visualization demo through the PyTorch port (the twin of
demo_visualization.py, the reference's demo/demo_visualization.ipynb as a
script): load a trained adapter checkpoint (the reference's shipped
MultipleAdapter ``.pth`` when ``--pth`` exists, else an untrained synthetic
adapter), push embeddings through it, and render group-wise statistics plus
2-D and 3-D embedding panels before and after adaptation.  Runs on the card
unless ``--device cpu``.

    python scripts/demo_visualization_torch.py [--out $TMPDIR/debias_vis] [--pth PATH]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# the trained model the reference repository ships, relative to its root
REFERENCE_PTH = os.path.join(
    "trained_model",
    "im_clip_t_clip_class_tl_adapter_reg_seq_alter_t_class_lr_1.0_bs_1024_lrr1.0_bsr_256_MA+rn.pth",
)


def norm_rows(m):
    # zero-row guard mirrors viz/analysis.py: a dead ReLU-MLP row would
    # 0/0-NaN the group stats and the joint projection
    return m / np.maximum(np.linalg.norm(m, axis=-1, keepdims=True), 1e-12)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "debias_vis"))
    ap.add_argument("--pth", default=REFERENCE_PTH)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    import matplotlib.pyplot as plt
    import torch

    from debiasing_multi_modal_tpu_torch.data.synthetic import (
        SyntheticSpec,
        make_synthetic_dataset,
    )
    from debiasing_multi_modal_tpu_torch.models.adapter import (
        AdapterMLP,
        MultipleAdapterClassifier,
    )
    from debiasing_multi_modal_tpu_torch.templates import get_prompts
    from debiasing_multi_modal_tpu_torch.train.metrics import results_from_counts
    from debiasing_multi_modal_tpu_torch.utils.platform import resolve_device
    from debiasing_multi_modal_tpu_torch.viz.analysis import adapted_embeddings, group_stats
    from debiasing_multi_modal_tpu_torch.viz.plots import (
        plot_splits,
        plot_splits_joint,
        split_stats_table,
    )
    from debiasing_multi_modal_tpu_torch.weights.convert import classifier_from_state_dict

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    use_reference = os.path.isfile(args.pth)
    if use_reference:
        classifier = classifier_from_state_dict(
            torch.load(args.pth, map_location="cpu", weights_only=True)).to(device)
        multiple = isinstance(classifier, MultipleAdapterClassifier)
        # blended adapted features = what the trained classifier normalizes
        adapters = ([classifier.old_cls.adapter, classifier.new_adapter] if multiple
                    else [classifier.adapter])
        dim = adapters[0].layers[0].in_features
        hidden = adapters[0].layers[0].out_features
        kind = "MultipleAdapter" if multiple else "single-adapter"
        print(f"loaded {kind} checkpoint (D={dim}, hidden={hidden})")
    else:
        print("reference .pth not found; demo uses an untrained adapter")
        dim, hidden = 64, 16
        adapters = [AdapterMLP(dim, hidden,
                               generator=torch.Generator().manual_seed(0)).to(device)]

    meta, table, tc, tg, ts = make_synthetic_dataset(SyntheticSpec(dim=dim, seed=3))
    raw = table.embeddings
    feats = [adapted_embeddings(mlp, None, None, raw) for mlp in adapters]
    adapted = (0.5 * norm_rows(feats[0]) + 0.5 * norm_rows(feats[1]) if len(feats) == 2
               else norm_rows(feats[0]) if use_reference else feats[0])

    print("\nGroup-wise embedding statistics (raw -> adapted):")
    stats_raw = group_stats(norm_rows(raw), table.group)
    stats_ad = group_stats(norm_rows(adapted), table.group)
    for g in sorted(stats_raw):
        r, a = stats_raw[g], stats_ad[g]
        print(
            f"  group {g}: n={r['count']:4d}  mean_norm {r['mean_norm']:.3f} -> "
            f"{a['mean_norm']:.3f}   pairwise_dist {r['mean_pairwise_dist']:.3f} -> "
            f"{a['mean_pairwise_dist']:.3f}"
        )

    splits, labels = {}, {}
    for name, emb in (("raw", norm_rows(raw)), ("adapted", norm_rows(adapted))):
        idx = np.where(table.split == 2)[0]  # test split
        splits[name] = emb[idx]
        labels[name] = {
            "group": table.group[idx],
            "target": table.y[idx],
            "spurious": table.place[idx],
            "prediction": table.y_pred[idx],
        }
    path = os.path.join(args.out, "raw_vs_adapted.png")
    fig = plot_splits(splits, labels, dataset="waterbirds", color_by="group",
                      method="pca", out_path=path)
    plt.close(fig)
    print("wrote", path)

    # ---- reference-style VisRepAll figure (demo/visualizer.py:182-262 +
    # plot_umap_all:411-638): ONE joint umap projection over train/val/test,
    # text-prompt anchors, group-centroid stars, per-split stat tables.
    adapted_n = norm_rows(adapted)
    # zero-shot head over the ADAPTED features (CustomCLIP.forward
    # semantics: normalized image side, un-normalized class columns)
    adapter_preds = np.argmax(adapted_n @ tc, axis=-1)  # tc is [D, C]
    ratio = np.bincount(
        table.group[table.split == 0], minlength=4
    ) / max(1, int((table.split == 0).sum()))
    prompts = get_prompts("waterbirds")
    text_names = [f"a photo of a {c}." for c in prompts.classes]
    embs3, labels3, tables3 = {}, {}, {}
    for name, sid in (("train", 0), ("val", 1), ("test", 2)):
        idx = np.where(table.split == sid)[0]
        embs3[name] = adapted_n[idx]
        # the table describes the LOADED adapter's own predictions, not the
        # synthetic zero-shot predictor (visualizer.py:200-225)
        preds = adapter_preds[idx]
        labels3[name] = {
            "group": table.group[idx], "target": table.y[idx],
            "spurious": table.place[idx], "prediction": preds,
        }
        correct = (preds == table.y[idx]).astype(np.float64)
        corr = np.bincount(table.group[idx], weights=correct, minlength=4)
        cnt = np.bincount(table.group[idx], minlength=4)
        accs = dict(results_from_counts(corr, cnt, 2, ratio))
        tables3[name] = split_stats_table(embs3[name], table.group[idx], accs)

    tag = "adapter_reg_seq_alter" if use_reference else "untrained"
    for dim_out, fname in ((2, "visrepall_2d.png"), (3, "visrepall_3d.png")):
        path = os.path.join(args.out, fname)
        fig, _ = plot_splits_joint(
            embs3, labels3, dataset="waterbirds", color_by="group",
            method="umap", text_embeddings=tc.T, text_names=text_names,
            stats_tables=tables3 if dim_out == 2 else None, out_path=path,
            n_components=dim_out,
            title=f"([{tag}] Representation (10 near.))",
        )
        plt.close(fig)
        print("wrote", path)


if __name__ == "__main__":
    main()
