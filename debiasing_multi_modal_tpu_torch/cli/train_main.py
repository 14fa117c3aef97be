"""Stage B CLI for the PyTorch port: regularized-adapter training (port of
``cli/train_main.py``, the same flags plus ``--device``).

    python -m debiasing_multi_modal_tpu_torch.cli.train_main \\
        --epochs 100 --learning_rate 1.0 --batch_size 1024 \\
        --epochs_feature_learning 40 --learning_rate_reg 1.0 --batch_size_reg 256 \\
        --dataset waterbirds \\
        --text_embedding_dir .../clip_class.json \\
        --text_spurious_embedding_dir .../clip_spurious.json \\
        --text_group_embedding_dir .../clip_group.json \\
        --image_embedding_dir .../RN50/clip.npz \\
        --data_dir .../waterbird_complete95_forest2water2 \\
        --tl_method adapter_reg_seq_alter --train_target class \\
        --warm_reg --lr_decay_rate 0.1 --lr_decay_epochs 90,95 \\
        --add_adapter --random_seed 42 --save_results

Runs on ``cuda`` unless ``--device cpu``.  ``--profile_dir`` writes a
``torch.profiler`` trace of the run; ``--checkpoint_dir`` takes torch
checkpoints (``train/checkpoint.py``).  ``--tl_method contrastive_adapter``
and its flags are accepted and raise ``NotImplementedError`` until the
contrastive slice ports it.
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser("adapter debiasing training (PyTorch port)")
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--save_freq", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--batch_size_reg", type=int, default=128)
    p.add_argument("--num_workers", type=int, default=16)  # accepted, unused (no DataLoader)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--learning_rate", type=float, default=1e-1)
    p.add_argument("--learning_rate_reg", type=float, default=1e-3)
    p.add_argument("--lr_decay_epochs", type=str, default="60,75,90")
    p.add_argument("--lr_decay_rate", type=float, default=1.0)
    p.add_argument("--weight_decay", type=float, default=5e-5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--model", type=str, default="resnet50")
    p.add_argument("--dataset", type=str, default="waterbirds",
                   choices=["celeba", "waterbirds"])
    p.add_argument("--cosine", action="store_true")
    p.add_argument("--warm", action="store_true")
    p.add_argument("--warm_reg", action="store_true")
    p.add_argument("--image_embedding_dir", type=str, required=True,
                   help="embedding cache (clip.json or clip.npz)")
    p.add_argument("--text_embedding_dir", type=str, required=True)
    p.add_argument("--text_group_embedding_dir", type=str, required=True)
    p.add_argument("--text_spurious_embedding_dir", type=str, required=True)
    p.add_argument("--train_target", type=str, default="class",
                   choices=["class", "spurious", "group"])
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument(
        "--tl_method", type=str, default="linear_probing",
        choices=["linear_probing", "adapter", "adapter_reg", "adapter_reg_seq",
                 "adapter_reg_seq_alter", "contrastive_adapter"],
    )
    p.add_argument("--balance_val", action="store_true")
    p.add_argument("--resample_ce", action="store_true")
    p.add_argument("--use_cls_prompt_in_reg", action="store_true")
    p.add_argument("--add_adapter", action="store_true", default=False)
    p.add_argument("--init_near_identity", action="store_true")
    p.add_argument("--epochs_feature_learning", type=int)
    p.add_argument("--continue_from_best", action="store_true")
    p.add_argument("--adapter_feat_dim", type=int, default=128)
    p.add_argument("--zs_temperature", type=float, default=0.01)
    # contrastive_adapter method (not ported yet; accepted for flag parity)
    p.add_argument("--num_anchor", type=int, default=1)
    p.add_argument("--num_positive", type=int, default=64)
    p.add_argument("--num_negative", type=int, default=64)
    p.add_argument("--cl_temperature", type=float, default=0.1)
    p.add_argument("--contrastive_weight", type=float, default=0.1)
    p.add_argument("--ca_ce_update", type=int, default=-1)
    p.add_argument("--no_ca_pre_norm", dest="ca_pre_norm",
                   action="store_false", default=True)
    p.add_argument("--ca_head", type=str, default=None, choices=["linear"])
    p.add_argument("--ca_feat_dim", type=int, default=128)
    p.add_argument("--batch_factor", type=int, default=4)
    p.add_argument("--watch_batch_results", action="store_true")
    p.add_argument("--save_results", action="store_true")
    p.add_argument("--random_seed", type=int, default=42)
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="enable mid-run checkpoints in this directory")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint_dir")
    p.add_argument("--checkpoint_every", type=int, default=10)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="train on the card or on the CPU")
    return p


def config_from_args(args):
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig

    decay = tuple(int(e) for e in args.lr_decay_epochs.split(","))
    return TrainConfig(
        batch_size=args.batch_size,
        batch_size_reg=args.batch_size_reg,
        epochs=args.epochs,
        learning_rate=args.learning_rate,
        learning_rate_reg=args.learning_rate_reg,
        lr_decay_epochs=decay,
        lr_decay_rate=args.lr_decay_rate,
        weight_decay=args.weight_decay,
        momentum=args.momentum,
        cosine=args.cosine,
        warm=args.warm,
        warm_reg=args.warm_reg,
        dataset=args.dataset,
        tl_method=args.tl_method,
        train_target=args.train_target,
        epochs_feature_learning=args.epochs_feature_learning,
        balance_val=args.balance_val,
        resample_ce=args.resample_ce,
        use_cls_prompt_in_reg=args.use_cls_prompt_in_reg,
        add_adapter=args.add_adapter,
        init_near_identity=args.init_near_identity,
        continue_from_best=args.continue_from_best,
        adapter_feat_dim=args.adapter_feat_dim,
        zs_temperature=args.zs_temperature,
        num_anchor=args.num_anchor,
        num_positive=args.num_positive,
        num_negative=args.num_negative,
        cl_temperature=args.cl_temperature,
        contrastive_weight=args.contrastive_weight,
        ca_ce_update=args.ca_ce_update,
        ca_pre_norm=args.ca_pre_norm,
        ca_head=args.ca_head,
        ca_feat_dim=args.ca_feat_dim,
        batch_factor=args.batch_factor,
        random_seed=args.random_seed,
        save_results=args.save_results,
        print_freq=args.print_freq,
        watch_batch_results=args.watch_batch_results,
    )


def main(args):
    from debiasing_multi_modal_tpu_torch.train.loop import bundle_from_files, train_all_epochs
    from debiasing_multi_modal_tpu_torch.utils.platform import resolve_device
    from debiasing_multi_modal_tpu_torch.utils.profiling import trace

    device = resolve_device(args.device)
    cfg = config_from_args(args)
    print(f"> Start Transfer Learning using [{cfg.tl_method}]")
    bundle = bundle_from_files(
        cfg.dataset,
        args.data_dir,
        args.image_embedding_dir,
        args.text_embedding_dir,
        args.text_spurious_embedding_dir,
        args.text_group_embedding_dir,
        device=device,
    )
    cfg = cfg.replace(input_dim=int(bundle.text_class.shape[0]))
    with trace(args.profile_dir or "", enabled=bool(args.profile_dir)):
        (tr, va, te), _, _ = train_all_epochs(
            cfg, bundle, verbose=True, results_dir=args.results_dir,
            checkpoint_dir=args.checkpoint_dir, resume=args.resume,
            checkpoint_every=args.checkpoint_every, device=device,
        )
    print("best train:", tr)
    print("best val:", va)
    print("best test:", te)
    return 0


def _entry():
    sys.exit(main(build_parser().parse_args()))


if __name__ == "__main__":
    _entry()
