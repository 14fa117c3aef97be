"""Sweep CLI for the PyTorch port: multi-seed (and hyperparameter-grid)
training with mean±std CSVs (port of ``cli/sweep_main.py``, the same flags
plus ``--device``).

Parity surface: reference ``run_multiple/final_main_iteration_wb.py``
(``--num_iter``, ``--random_seeds``) and ``..._iteration_ca.py``
(``--lr_list/--bs_list/--bsr_list``, ``--lr_multiple``), writing per-cell
CSVs under ``results_iterative/``.  Seeds run as ONE stacked program by
default (``--no_vmap`` falls back to the sequential loop); ``--stack_*``
stack the grid's axes into it.  Runs on ``cuda`` unless ``--device cpu``.
``--seed_mesh`` shards each stacked program's rows over every rank of the
process group (``torchrun``, one process per card; one process alone is a
group of one); rank 0 writes the CSVs.  ``--profile_dir`` writes a
``torch.profiler`` trace of the sweep, with the sweep's spans in it
(``utils/profiling.py``).

    python -m debiasing_multi_modal_tpu_torch.cli.sweep_main \\
        --tl_method adapter_reg_seq_alter --add_adapter --warm_reg \\
        --epochs 100 --epochs_feature_learning 40 --lr_list 1,10 \\
        --bs_list 512,1024 --bsr_list 64,128,256,512 --lr_multiple 1 \\
        --stack_lr_axis --stack_bsr_axis --stack_bs_axis \\
        --image_embedding_dir .../RN50/clip.npz ... --data_dir ...
"""

from __future__ import annotations

import sys

from debiasing_multi_modal_tpu_torch.cli.train_main import build_parser, config_from_args


def extend_parser(p):
    p.add_argument("--num_iter", type=int, default=3)
    p.add_argument("--random_seeds", type=str, default="42,32,22")
    p.add_argument("--lr_list", type=str, default="")
    p.add_argument("--bs_list", type=str, default="")
    p.add_argument("--bsr_list", type=str, default="")
    p.add_argument("--lr_multiple", type=float, default=None)
    p.add_argument("--result_root", type=str, default="results_iterative")
    p.add_argument("--no_vmap", action="store_true")
    p.add_argument("--skip_existing", action="store_true",
                   help="skip grid cells whose result CSV already exists "
                        "(crash-safe re-run of an interrupted sweep)")
    p.add_argument("--stack_lr_axis", action="store_true",
                   help="train all --lr_list cells as stacked rows of one "
                        "program (identical results, one set of launches per step)")
    p.add_argument("--stack_bsr_axis", action="store_true",
                   help="additionally stack the --bsr_list axis (reg "
                        "methods): shorter reg epochs pad and no-op, so the "
                        "whole lr x bsr grid per train batch size is one program")
    p.add_argument("--stack_bs_axis", action="store_true",
                   help="additionally stack the --bs_list axis: train "
                        "epochs pad per row too, so the ENTIRE grid is ONE "
                        "program (requires the inner axes stacked or singleton)")
    p.add_argument("--seed_mesh", action="store_true",
                   help="shard each cell's seed axis across the ranks "
                        "(torchrun: one process per card)")
    return p


def main(args):
    from debiasing_multi_modal_tpu_torch.utils.platform import resolve_device

    cfg = config_from_args(args)
    all_seeds = [int(s) for s in args.random_seeds.split(",")]
    if args.num_iter > len(all_seeds):
        # the reference indexes random_seeds[iter-1] and fails loudly
        # (final_main_iteration_wb.py:1129-1132); silent truncation would
        # aggregate fewer runs than the user asked for
        raise SystemExit(
            f"--num_iter {args.num_iter} > {len(all_seeds)} seeds in "
            f"--random_seeds {args.random_seeds!r}"
        )
    seeds = all_seeds[: args.num_iter]
    if args.save_results:
        raise SystemExit(
            "--save_results is not supported by sweep_main (the sweep's "
            "outputs are the per-cell CSVs under --result_root)"
        )
    for flag in ("checkpoint_dir", "resume"):
        if getattr(args, flag, None):
            # inherited from the train parser but not wired through the
            # sweep: rejecting beats silently producing nothing
            raise SystemExit(
                f"--{flag} is not supported by sweep_main (per-run "
                "checkpoints are a train_main feature)"
            )
    if (args.stack_lr_axis or args.stack_bsr_axis or args.stack_bs_axis) \
            and args.no_vmap:
        # contradictory flags fail BEFORE any file IO (the stacked grid
        # only exists on the stacked path)
        raise SystemExit(
            "--stack_lr_axis/--stack_bsr_axis/--stack_bs_axis require the "
            "vmapped path; drop --no_vmap"
        )
    if not args.seed_mesh:
        return _sweep(args, cfg, seeds, resolve_device(args.device), None)
    from debiasing_multi_modal_tpu_torch.parallel import multihost
    from debiasing_multi_modal_tpu_torch.parallel.mesh import make_mesh

    with multihost.process_group(args.device):
        return _sweep(args, cfg, seeds, multihost.local_device(args.device),
                      make_mesh(axis_names=("data",), device=args.device))


def _sweep(args, cfg, seeds, device, mesh):
    """The sweep itself; ``mesh`` shards the stacked rows (None: one process)."""
    from debiasing_multi_modal_tpu_torch.sweep.runner import run_sweep
    from debiasing_multi_modal_tpu_torch.train.loop import bundle_from_files
    from debiasing_multi_modal_tpu_torch.utils.profiling import trace

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

    def parse_list(s, typ):
        return [typ(v) for v in s.split(",")] if s else (None,)

    with trace(args.profile_dir or "", enabled=bool(args.profile_dir)):
        out = run_sweep(
            cfg,
            bundle,
            seeds,
            lr_list=parse_list(args.lr_list, float),
            bs_list=parse_list(args.bs_list, int),
            bsr_list=parse_list(args.bsr_list, int),
            lr_multiple=args.lr_multiple,
            result_root=args.result_root,
            use_vmap=not args.no_vmap,
            verbose=True,
            stack_lr_axis=args.stack_lr_axis,
            stack_bsr_axis=args.stack_bsr_axis,
            stack_bs_axis=args.stack_bs_axis,
            skip_existing=args.skip_existing,
            mesh=mesh,
            device=device,
        )
    if mesh is None or mesh.get_rank() == 0:
        for path in out:
            print("wrote", path)
    return 0


def _entry():
    """console-script entry point (pyproject.toml)."""
    sys.exit(main(extend_parser(build_parser()).parse_args()))


if __name__ == "__main__":
    _entry()
