"""Stage A CLI for the PyTorch port: embedding extraction + zero-shot
prediction (port of ``cli/extract_main.py``, same flags plus ``--device``).

    python -m debiasing_multi_modal_tpu_torch.cli.extract_main \\
        --data_dir data --dataset waterbirds --embedding_dir embeddings_unnormalized \\
        --save --split all --backbone ViT-B/32 --quantize int8_pallas

Runs on ``cuda`` (bf16 towers) unless ``--device cpu`` (f32).  Without
``--checkpoint`` the model runs with seeded random weights (pipeline
testing).  Every ResNet and ViT backbone runs; ``--quantize int8`` (the
plain integer product) or ``int8_pallas`` (kernel 7) quantizes the ViT image
tower's Dense GEMMs and raises ``ValueError`` on a ResNet, as the JAX CLI
refuses it.  ``--fuse_bn`` folds a ResNet's frozen BatchNorms into its
convs (``weights/fold.py``) after loading or seeding the weights, and exits
on a ViT.  ``--tensor_parallel`` above 1 is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

BACKBONES = ["RN50", "RN101", "RN50x4", "RN50x16", "RN50x64",
             "ViT-B/32", "ViT-B/16", "ViT-L/14", "ViT-L/14@336px"]


def build_parser():
    p = argparse.ArgumentParser("clip embedding extraction (PyTorch port)")
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--dataset", default="celeba", choices=["celeba", "waterbirds"])
    p.add_argument("--split", default="all", choices=["train", "val", "test", "all"])
    p.add_argument("--backbone", default="RN50", choices=BACKBONES)
    p.add_argument("--normalized", default=False, action="store_true",
                   help="store L2-normalized embeddings (reference stores un-normalized)")
    p.add_argument("--embedding_dir", default="./embeddings")
    p.add_argument("--save", default=False, action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="local OpenAI .pt checkpoint; random init if omitted")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--format", default="both", choices=["json", "npz", "both"])
    p.add_argument("--host_resolution", type=int, default=224,
                   help="host-side resize/crop target; 0 = raw decode, geometry on device")
    p.add_argument("--fuse_bn", action="store_true",
                   help="fold the frozen ResNet BatchNorms into the convs (ResNet only)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the first split here")
    p.add_argument("--num_workers", type=int, default=None,
                   help="decode threads; default = host cpu count")
    p.add_argument("--shard_every", type=int, default=0,
                   help="crash-safe mode: persist a result shard every N "
                        "batches; a re-run resumes after the last complete shard")
    p.add_argument("--quantize", default="none",
                   choices=["none", "int8", "int8_pallas"],
                   help="dynamic W8A8 int8 GEMMs in the ViT image tower: int8 = "
                        "the plain integer product, int8_pallas = the int8 "
                        "GEMM kernel (ViT backbones only)")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="shard encoder params over this many devices (not yet ported)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (bf16 towers) or the CPU (f32)")
    return p


def main(args):
    if args.tensor_parallel > 1:
        raise NotImplementedError("--tensor_parallel > 1 is not yet ported")

    from debiasing_multi_modal_tpu_torch.data.embeddings_store import (
        EmbeddingTable,
        save_embeddings,
        save_text_embeddings,
    )
    from debiasing_multi_modal_tpu_torch.data.groups import load_metadata
    from debiasing_multi_modal_tpu_torch.data.images import image_batches
    from debiasing_multi_modal_tpu_torch.extract.runner import (
        ExtractionRunner,
        encode_text_prompts,
        minority_report,
    )
    from debiasing_multi_modal_tpu_torch.models import create_clip
    from debiasing_multi_modal_tpu_torch.templates import get_prompts
    from debiasing_multi_modal_tpu_torch.utils.platform import (
        compute_dtype,
        resolve_device,
    )
    from debiasing_multi_modal_tpu_torch.utils.profiling import trace
    from debiasing_multi_modal_tpu_torch.weights.convert import (
        clip_from_state_dict,
        load_openai_checkpoint,
    )
    from debiasing_multi_modal_tpu_torch.weights.fold import fold_resnet_bn

    device = resolve_device(args.device)
    dtype = compute_dtype(device)
    # quant raises ValueError on a ResNet (CLIP's own check)
    if args.checkpoint:
        model = clip_from_state_dict(load_openai_checkpoint(args.checkpoint),
                                     name=args.backbone, dtype=dtype, device=device,
                                     quant=args.quantize)
        print(f"loaded checkpoint {args.checkpoint} ({model.config.name})")
    else:
        model = create_clip(args.backbone, dtype=dtype, device=device,
                            quant=args.quantize)
        print(f"WARNING: no --checkpoint given; {args.backbone} runs with random weights")
    if args.fuse_bn:
        if model.config.is_vit:
            raise SystemExit("--fuse_bn applies to ResNet backbones only")
        folded = fold_resnet_bn({k: v.cpu().numpy() for k, v in model.state_dict().items()})
        model = clip_from_state_dict(folded, name=model.config.name, dtype=dtype,
                                     device=device, fuse_bn=True)
        print("folded frozen BatchNorms into the convolutions")
    if args.quantize != "none":
        print(f"vision tower Dense GEMMs running {args.quantize} W8A8")

    prompts = get_prompts(args.dataset)
    tpp = len(prompts.templates)
    text = encode_text_prompts(
        model,
        {kind: prompts.prompts(kind) for kind in ("class", "spurious", "group")},
        templates_per_phrase=tpp,
    )

    emb_root = os.path.join(args.data_dir, args.embedding_dir, args.dataset)
    if args.save:
        os.makedirs(emb_root, exist_ok=True)
        for kind in ("class", "spurious", "group"):
            # one pooled row per phrase, keyed by its first template's rendering
            save_text_embeddings(
                os.path.join(emb_root, f"clip_{kind}.json"),
                list(prompts.prompts(kind))[::tpp],
                text[kind],
            )
            print(f"save text emb ({kind})")

    runner = ExtractionRunner(model, text["class"], normalized=args.normalized)

    if args.dataset == "waterbirds":
        image_root = os.path.join(
            args.data_dir, "waterbirds", "waterbird_complete95_forest2water2"
        )
        meta_root = image_root
        path_for = None
    else:
        meta_root = os.path.join(args.data_dir, "celeba")
        img_dir = os.path.join(meta_root, "img_align_celeba", "img_align_celeba")
        path_for = lambda fn: os.path.join(img_dir, fn)  # noqa: E731
        image_root = img_dir

    splits = ["train", "val", "test"] if args.split == "all" else [args.split]
    host_res = args.host_resolution or None
    tables = []
    for split in splits:
        meta = load_metadata(args.dataset, meta_root, split)
        t0 = time.time()
        shard_dir = shard_meta = None
        if args.shard_every:
            shard_dir = os.path.join(
                emb_root, args.backbone.replace("/", "-"), f"shards_{split}"
            )
            # the settings that change the persisted numbers: resuming into
            # shards from a different configuration is an error
            shard_meta = {
                "backbone": args.backbone,
                "checkpoint": args.checkpoint or "random",
                "normalized": bool(args.normalized),
                "fuse_bn": bool(args.fuse_bn),
                "batch_size": args.batch_size,
                "host_resolution": args.host_resolution,
                "split": split,
                "compute_dtype": str(dtype).replace("torch.", ""),
                "tensor_parallel": args.tensor_parallel,
                "quantize": args.quantize,
            }
        profiling = bool(args.profile_dir) and split == splits[0]
        with trace(args.profile_dir, enabled=profiling):
            table = runner.run(
                image_batches(meta, image_root, args.batch_size, host_res,
                              path_for, decode_workers=args.num_workers),
                shard_dir=shard_dir,
                shard_every=args.shard_every,
                shard_meta=shard_meta,
            )
        dt = time.time() - t0
        print(f"{split}: {len(table)} images in {dt:.1f}s "
              f"({len(table) / max(dt, 1e-9):.0f} imgs/s)")
        print(minority_report(table.y, table.place, table.y_pred, args.dataset))
        tables.append(table)

    if args.save:
        merged = EmbeddingTable(**{
            f: np.concatenate([getattr(t, f) for t in tables])
            for f in ("filenames", "y", "place", "group", "split", "y_pred", "embeddings")
        })
        out_dir = os.path.join(emb_root, args.backbone.replace("/", "-"))
        os.makedirs(out_dir, exist_ok=True)
        if args.format in ("json", "both"):
            save_embeddings(os.path.join(out_dir, "clip.json"), merged, fmt="json",
                            dataset=args.dataset)
        if args.format in ("npz", "both"):
            save_embeddings(os.path.join(out_dir, "clip.npz"), merged, fmt="npz")
        print(f"dataset size: {len(merged)}")
        print("save img and pred")


def _entry():
    sys.exit(main(build_parser().parse_args()))


if __name__ == "__main__":
    _entry()
