#!/usr/bin/env python
"""Executable demo through the PyTorch port (the twin of demo_train.py, the
reference's demo/demo_train.ipynb equivalent): runs the full two-phase
debiasing method on the synthetic spurious-correlation fixture end to end,
prints the per-epoch trajectory, and renders the embedding-space panels
before and after adaptation.  Runs on the card unless ``--device cpu``.

    python scripts/demo_train_torch.py [--epochs 24] [--out $TMPDIR/debias_demo] [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

BASE = dict(dataset="waterbirds", input_dim=64, adapter_feat_dim=16, batch_size=128,
            batch_size_reg=32, learning_rate=0.5, learning_rate_reg=0.5,
            lr_decay_epochs=(1000,))


def debiased_config(epochs: int, feature_epochs: int):
    """GCP-Seq-MA: the demo's debiased configuration."""
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig

    return TrainConfig(tl_method="adapter_reg_seq_alter", epochs=epochs,
                       epochs_feature_learning=feature_epochs, add_adapter=True,
                       init_near_identity=True, continue_from_best=True, balance_val=True,
                       **BASE)


def demo_bundle(device):
    from debiasing_multi_modal_tpu_torch.data.synthetic import (
        SyntheticSpec,
        make_synthetic_dataset,
    )
    from debiasing_multi_modal_tpu_torch.train.loop import bundle_from_embedding_table

    meta, table, tc, tg, ts = make_synthetic_dataset(SyntheticSpec())
    mbs = {n: meta.take(np.where(meta.split == s)[0])
           for n, s in (("train", 0), ("val", 1), ("test", 2))}
    return table, bundle_from_embedding_table(table, mbs, tc, ts, tg, device=device)


def _norm(m):
    return m / np.maximum(np.linalg.norm(m, axis=-1, keepdims=True), 1e-12)


def best_adapted(ckdir, embeddings, hidden, device):
    """The trained best model's adapted features, re-loaded from the final
    checkpoint (the "after adaptation" panel)."""
    import torch

    from debiasing_multi_modal_tpu_torch.models.adapter import AdapterMLP
    from debiasing_multi_modal_tpu_torch.train import checkpoint as ckpt
    from debiasing_multi_modal_tpu_torch.viz.analysis import adapted_embeddings

    _, tree, _ = ckpt.load_checkpoint(ckpt.latest_checkpoint(ckdir))
    if "best_state" in tree:
        sd = tree["best_state"]
    else:
        # degenerate short runs may never improve val-worst; fall back to
        # the final model (the loop's own degenerate-run fallback)
        final = tree.get("ma_state", tree["state"])
        sd = {**final["params"], **final["batch_stats"]}
    mlp = AdapterMLP(embeddings.shape[1], hidden,
                     generator=torch.Generator().manual_seed(0)).to(device)

    def through(prefix):
        sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        return adapted_embeddings(mlp, sub, None, embeddings)

    if "old_cls.adapter.layers.0.weight" in sd:  # MultipleAdapter best: the 0.5/0.5 blend
        return 0.5 * _norm(through("old_cls.adapter.")) + 0.5 * _norm(through("new_adapter."))
    return through("adapter.")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--feature_epochs", type=int, default=6)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "debias_demo"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
    from debiasing_multi_modal_tpu_torch.train.loop import train_all_epochs
    from debiasing_multi_modal_tpu_torch.train.metrics import ordered
    from debiasing_multi_modal_tpu_torch.utils.platform import resolve_device
    from debiasing_multi_modal_tpu_torch.viz.plots import plot_splits

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    table, bundle = demo_bundle(device)

    print("=== ERM adapter (biased) ===")
    erm = TrainConfig(tl_method="adapter", epochs=args.feature_epochs, **BASE)
    (_, _, te_erm), _, _ = train_all_epochs(erm, bundle, verbose=False, device=device)
    print("ERM test:", te_erm)

    print("=== GCP-Seq-MA (debiased) ===")
    cfg = debiased_config(args.epochs, args.feature_epochs)
    ckdir = os.path.join(args.out, "ckpt")
    (tr, va, te), (zs_c, zs_s), hist = train_all_epochs(
        cfg, bundle, verbose=False, checkpoint_dir=ckdir, checkpoint_every=0, device=device)
    for i, t in enumerate(hist["test"]):
        marker = " <== phase 2" if i + 1 == args.feature_epochs + 1 else ""
        print(f"epoch {i+1:3d}  test worst {t['worst_acc']:.4f}  mean {t['mean_acc']:.4f}{marker}")
    print("best test:", ordered(te))
    print(f"worst-group: ERM {te_erm['worst_acc']:.4f} -> debiased {te['worst_acc']:.4f}")

    # embedding panels colored by group: raw AND the trained best model's
    # adapted features
    adapted = best_adapted(ckdir, table.embeddings, BASE["adapter_feat_dim"], device)
    splits, labels = {}, {}
    for name, sid, emb in (
        ("train", 0, table.embeddings),
        ("test", 2, table.embeddings),
        ("test (adapted)", 2, adapted),
    ):
        idx = np.where(table.split == sid)[0]
        splits[name] = emb[idx]
        labels[name] = {
            "group": table.group[idx], "target": table.y[idx],
            "spurious": table.place[idx], "prediction": table.y_pred[idx],
        }
    path = os.path.join(args.out, "embeddings_by_group.png")
    plot_splits(splits, labels, dataset="waterbirds", color_by="group",
                method="pca", out_path=path)
    print("wrote", path)


if __name__ == "__main__":
    main()
