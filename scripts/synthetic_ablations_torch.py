#!/usr/bin/env python
"""Run the synthetic ablation ladder through the PyTorch port (the twin of
synthetic_ablations.py; docs/SYNTHETIC_ABLATIONS.md).

Nine method configurations at Waterbirds scale on the synthetic
spurious-correlation fixture, 3 seeds each trained as stacked rows, printed
as the markdown table the doc records.  Runs on the card unless
``--device cpu``.

    python scripts/synthetic_ablations_torch.py [--small] [--rows 0,7] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def ladder(epochs, feat, lp_epochs, erm_epochs):
    two_phase = dict(epochs=epochs, epochs_feature_learning=feat)
    return [
        ("linear_probing", dict(tl_method="linear_probing", epochs=lp_epochs)),
        ("ERM adapter", dict(tl_method="adapter", epochs=erm_epochs)),
        ("GP-Alter", dict(tl_method="adapter_reg", epochs=epochs)),
        ("CP-Alter", dict(tl_method="adapter_reg", epochs=epochs,
                          use_cls_prompt_in_reg=True)),
        ("GP-Seq", dict(tl_method="adapter_reg_seq", **two_phase)),
        ("CP-Seq", dict(tl_method="adapter_reg_seq", **two_phase,
                        use_cls_prompt_in_reg=True)),
        ("GCP-Seq (no MA)", dict(tl_method="adapter_reg_seq_alter", **two_phase)),
        ("GCP-Seq-MA", dict(tl_method="adapter_reg_seq_alter", **two_phase,
                            add_adapter=True)),
        ("GCP-Seq-MA + balval", dict(tl_method="adapter_reg_seq_alter",
                                     **two_phase, add_adapter=True,
                                     balance_val=True)),
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="tiny CPU smoke run")
    ap.add_argument("--seeds", default="42,32,22")
    ap.add_argument("--rows", default="",
                    help="comma list of 0-based ladder rows to run (default all)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    from debiasing_multi_modal_tpu_torch.data.synthetic import (
        SyntheticSpec,
        make_synthetic_dataset,
    )
    from debiasing_multi_modal_tpu_torch.sweep.runner import run_seeds
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
    from debiasing_multi_modal_tpu_torch.train.loop import bundle_from_embedding_table
    from debiasing_multi_modal_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    if args.small:
        spec = SyntheticSpec(n_train=256, n_val=128, n_test=128, dim=64)
        base = dict(batch_size=64, batch_size_reg=16, input_dim=64,
                    adapter_feat_dim=16)
        epochs, feat = 6, 2
        lp_epochs, erm_epochs = 2, 4
    else:
        # Waterbirds scale + the reference's best hyperparameters
        spec = SyntheticSpec(n_train=4795, n_val=1199, n_test=5794, dim=1024)
        base = dict(batch_size=1024, batch_size_reg=256, input_dim=1024)
        epochs, feat = 100, 40
        lp_epochs, erm_epochs = 20, 40

    meta, table, tc, tg, ts = make_synthetic_dataset(spec)
    mbs = {
        n: meta.take(np.where(meta.split == s)[0])
        for n, s in (("train", 0), ("val", 1), ("test", 2))
    }
    bundle = bundle_from_embedding_table(table, mbs, tc, ts, tg, device=device)
    seeds = [int(s) for s in args.seeds.split(",")]

    common = dict(
        dataset="waterbirds", learning_rate=1.0, learning_rate_reg=1.0,
        lr_decay_epochs=(90, 95), lr_decay_rate=0.1, warm_reg=True, **base,
    )
    rows = ([int(r) for r in args.rows.split(",")] if args.rows
            else list(range(9)))
    print(f"| Method | test wga (mean ± std) | test wmean | wall ({len(seeds)} seeds) |")
    print("|---|---|---|---|")
    for i, (name, kw) in enumerate(ladder(epochs, feat, lp_epochs, erm_epochs)):
        if i not in rows:
            continue
        cfg = TrainConfig(**{**common, **kw})
        t0 = time.time()
        results = run_seeds(cfg, bundle, seeds, use_vmap=True, device=device)
        dt = time.time() - t0
        wga = np.array([r[0][2]["worst_acc"] for r in results])
        wm = np.array([r[0][2]["weighted_mean_acc"] for r in results])
        print(
            f"| {name} | {wga.mean():.4f} ± {wga.std():.4f} "
            f"| {wm.mean():.4f} | {dt:.0f} s |",
            flush=True,
        )


if __name__ == "__main__":
    main()
