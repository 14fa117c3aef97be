#!/usr/bin/env python3
"""Break a Stage-A slice of the PyTorch port down on one NVIDIA card (bf16,
seeded random weights, the shapes ``chip_smoke.py`` drives):

    python3 chip_profile.py [--backbone RN50|ViT-B/32|...] \
        [--quant none|int8|int8_pallas] [--fuse_qkv] [--batch 256] [--out DIR]

with ``--fuse_bn`` (a ResNet), the same image stages for the tower with its
BatchNorms folded (``weights/fold.py``) beside the unfused tower's; with
``--bottleneck``, kernels 8 and 9 (``ops/conv_gemm.py``,
``ops/fused_bottleneck.py``) against their plain version and the model's
own folded block at RN50's stride-1 block shapes (the port's counterpart of
``scripts/profile_conv_gemm.py``):

    python3 chip_profile.py --fuse_bn
    python3 chip_profile.py --bottleneck [--batch 256]

or, with ``--train``, one training step of the symmetric contrastive loss
through the whole CLIP (bf16 compute, f32 parameters, ``torch.optim.SGD``;
``--backbone`` default ViT-B/32, ``--attn_impl`` default "pallas",
``--remat``, ``--batch`` default 128):

    python3 chip_profile.py --train [--backbone ViT-B/32] \
        [--attn_impl pallas|auto|xla] [--remat]

Each line it prints is one JSON object:

- ``stages``: device time of each stage of one ``ExtractionRunner`` image
  step (ResNet: preprocess, stem, layer1-4, attention pool, zero-shot head;
  ViT: preprocess, patch embedding, attention blocks, MLP blocks, the rest of
  the transformer, the class-token head, zero-shot head) and of one text
  encode (attention blocks, MLP blocks, the rest), from CUDA events recorded
  by forward hooks; the median over repeated runs, in ms;
- ``kernels``: device time summed by kernel name under ``torch.profiler``
  over a few image steps and text encodes, with the share of the profiled
  wall time in which no kernel ran (``idle_share``).
- ``image_stages_ms`` with ``fuse_bn`` true and false (``--fuse_bn``);
- ``bottleneck_ms`` (``--bottleneck``): per block shape, the device ms of
  kernel 8 at each ``strip_rows`` and ``images_per_cell`` whose tiles fit
  shared memory, of kernel 9 at its own strip, of the plain version and of
  the model's ``Bottleneck.forward``, with the block's FLOP count
  (``utils/timing.py::time_ms``, 10 runs of 5 calls);
- ``train_stages`` (``--train``): device time of each stage of one training
  step (preprocess, forward with the image tower and the text transformer
  inside it, backward, optimizer), from CUDA events; ``train_step_kernels``:
  the same step under ``torch.profiler``.

Every line names the card and its power limit.  ``chip_smoke.py`` takes
:func:`kernel_breakdown` from here.
"""

import argparse
import functools
import json
import os
import statistics
import subprocess
import time

import torch

from debiasing_multi_modal_tpu_torch.utils.profiling import trace
from debiasing_multi_modal_tpu_torch.utils.timing import time_ms


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _hook_events(modules):
    """Forward hooks that record a CUDA event on entry to and exit from each
    named module, into one dict that each run refills."""
    events = {}
    handles = []
    for name, mod in modules.items():
        handles.append(mod.register_forward_pre_hook(
            lambda m, i, name=name: events.__setitem__(name + ":in", _event())))
        handles.append(mod.register_forward_hook(
            lambda m, i, o, name=name: events.__setitem__(name + ":out", _event())))
    return events, handles


def _median_spans(run, spans, reps):
    """Median ms of each (label, start key, end key) span over ``reps`` runs
    of ``run()``, which returns the dict of recorded events."""
    samples = {label: [] for label, _, _ in spans}
    for _ in range(reps):
        events = run()
        torch.cuda.synchronize()
        for label, a, b in spans:
            samples[label].append(events[a].elapsed_time(events[b]))
    return {label: statistics.median(v) for label, v in samples.items()}


def image_stages(runner, uploaded, reps=10):
    v = runner.model.visual
    mods = {"visual": v, "attnpool": v.attnpool,
            **{f"layer{i}": getattr(v, f"layer{i}") for i in range(1, 5)}}
    events, handles = _hook_events(mods)

    def run():
        events["start"] = _event()
        runner.encode_batch_async(uploaded)
        events["end"] = _event()
        return events

    spans = [("preprocess", "start", "visual:in"), ("stem", "visual:in", "layer1:in")]
    spans += [(f"layer{i}", f"layer{i}:in", f"layer{i}:out") for i in range(1, 5)]
    spans += [("attnpool", "attnpool:in", "attnpool:out"),
              ("zero_shot_head", "attnpool:out", "end"), ("total", "start", "end")]
    try:
        run()  # warm-up
        return _median_spans(run, spans, reps)
    finally:
        for h in handles:
            h.remove()


def vit_image_stages(runner, uploaded, reps=10):
    v = runner.model.visual
    blocks = v.transformer.resblocks
    mods = {"visual": v, "transformer": v.transformer}
    for i, blk in enumerate(blocks):
        mods[f"attn{i}"], mods[f"mlp{i}"] = blk.attn, blk.mlp
    events, handles = _hook_events(mods)

    def run():
        events["start"] = _event()
        runner.encode_batch_async(uploaded)
        events["end"] = _event()
        return events

    n = len(blocks)
    spans = [("preprocess", "start", "visual:in"),
             ("patch_embed", "visual:in", "transformer:in"),
             ("transformer", "transformer:in", "transformer:out"),
             ("class_token_head", "transformer:out", "visual:out"),
             ("zero_shot_head", "visual:out", "end"), ("total", "start", "end")]
    spans += [(f"attn{i}", f"attn{i}:in", f"attn{i}:out") for i in range(n)]
    spans += [(f"mlp{i}", f"mlp{i}:in", f"mlp{i}:out") for i in range(n)]
    try:
        run()  # warm-up
        t = _median_spans(run, spans, reps)
    finally:
        for h in handles:
            h.remove()
    attn = sum(t.pop(f"attn{i}") for i in range(n))
    mlp = sum(t.pop(f"mlp{i}") for i in range(n))
    t["attention_blocks"], t["mlp_blocks"] = attn, mlp
    t["transformer_rest"] = t["transformer"] - attn - mlp
    return t


def text_stages(model, tokens, reps=10):
    blocks = model.transformer.resblocks
    mods = {}
    for i, blk in enumerate(blocks):
        mods[f"attn{i}"], mods[f"mlp{i}"] = blk.attn, blk.mlp
    events, handles = _hook_events(mods)

    def run():
        events["start"] = _event()
        with torch.inference_mode():
            model.encode_text(tokens)
        events["end"] = _event()
        return events

    n = len(blocks)
    spans = [(f"attn{i}", f"attn{i}:in", f"attn{i}:out") for i in range(n)]
    spans += [(f"mlp{i}", f"mlp{i}:in", f"mlp{i}:out") for i in range(n)]
    spans += [("total", "start", "end")]
    try:
        run()
        t = _median_spans(run, spans, reps)
    finally:
        for h in handles:
            h.remove()
    attn = sum(t[f"attn{i}"] for i in range(n))
    mlp = sum(t[f"mlp{i}"] for i in range(n))
    return {"attention_blocks": attn, "mlp_blocks": mlp,
            "rest": t["total"] - attn - mlp, "total": t["total"]}


def train_stages(model, opt, images, tokens, reps=10):
    """Median device ms of each stage of one contrastive training step of
    ``model`` on uint8 ``images`` and ``tokens``, and the step function (for
    :func:`kernel_breakdown`)."""
    import torch.nn.functional as F

    from debiasing_multi_modal_tpu_torch.ops.preprocess import preprocess_uint8

    cfg = model.config
    labels = torch.arange(tokens.shape[0], device=tokens.device)
    events, handles = _hook_events({"visual": model.visual, "text": model.transformer})

    def run():
        events["start"] = _event()
        opt.zero_grad(set_to_none=True)
        imgs = preprocess_uint8(images, cfg.image_resolution, dtype=cfg.dtype)
        events["preprocessed"] = _event()
        per_image, per_text = model(imgs, tokens)
        loss = (F.cross_entropy(per_image, labels) + F.cross_entropy(per_text, labels)) / 2
        events["forward"] = _event()
        loss.backward()
        events["backward"] = _event()
        opt.step()
        events["end"] = _event()
        return events

    spans = [("preprocess", "start", "preprocessed"),
             ("forward", "preprocessed", "forward"),
             ("image_tower_forward", "visual:in", "visual:out"),
             ("text_transformer_forward", "text:in", "text:out"),
             ("backward", "forward", "backward"),
             ("optimizer", "backward", "end"), ("total", "start", "end")]
    try:
        run()  # warm-up
        return _median_spans(run, spans, reps), run
    finally:
        for h in handles:
            h.remove()


# RN50's stride-1 bottleneck blocks: (name, H = W, Cin, M, Cout, downsample)
BOTTLENECK_SHAPES = [
    ("l1b0_ds", 56, 64, 64, 256, True),
    ("l1b1", 56, 256, 64, 256, False),
    ("l2b1", 28, 512, 128, 512, False),
    ("l3b1", 14, 1024, 256, 1024, False),
    ("l4b1", 7, 2048, 512, 2048, False),
]


def bottleneck_profile(batch, card, strips=(4, 7, 8, 14, 28), groups=(1, 2)):
    """One ``bottleneck_ms`` line per block shape (bf16, seeded random
    folded weights; see the module docstring)."""
    from debiasing_multi_modal_tpu_torch.models.resnet import Bottleneck
    from debiasing_multi_modal_tpu_torch.ops import conv_gemm as cg
    from debiasing_multi_modal_tpu_torch.ops import fused_bottleneck as fb

    ms = functools.partial(time_ms, runs=10, calls=5, warmup=2)
    gen = torch.Generator().manual_seed(0)
    for name, h, cin, m, cout, ds in BOTTLENECK_SHAPES:
        block = Bottleneck(cin, m, dtype=torch.bfloat16, fuse_bn=True)
        with torch.no_grad():
            for prm in block.parameters():  # lecun-normal weights, N(0, 0.1^2) biases
                std = prm[0].numel() ** -0.5 if prm.ndim > 1 else 0.1
                prm.copy_(torch.randn(prm.shape, generator=gen) * std)
        block = block.cuda().eval()
        x = torch.randn(batch, cin, h, h, generator=gen).to("cuda", torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        xn, w = x.permute(0, 2, 3, 1), cg.block_weights(block)
        macs = cin * m + 9 * m * m + m * cout + (cin * cout if ds else 0)
        row = {"profile": "bottleneck_ms", "card": card, "block": name, "batch": batch,
               "dtype": "bfloat16", "flops": 2 * batch * h * h * macs}
        with torch.inference_mode():
            row["plain_ms"] = ms(lambda: cg.xla_bottleneck(xn, *w))
            row["model_block_ms"] = ms(lambda: block(x))
            for strip in strips:
                for g in groups:
                    key = f"kernel8_s{strip}_g{g}_ms"
                    if h % strip or batch % g:
                        continue
                    if cg.smem_bytes(h, m, strip, g, 2) > cg.SMEM_LIMIT_BYTES:
                        row[key] = "does not fit shared memory"
                        continue
                    row[key] = ms(lambda: cg.fused_bottleneck_gemm(
                        xn, *w, strip_rows=strip, images_per_cell=g))
            if not ds:
                row["kernel9_strip"] = fb.strip_rows(h, h, m, 2)
                row["kernel9_ms"] = ms(lambda: fb.fused_bottleneck(xn, *w[:6]))
        print(json.dumps(row), flush=True)
        del block, x, xn, w


def kernel_breakdown(fn, reps=3, top=20, log_dir=None):
    """Device time by kernel name over ``reps`` calls of ``fn`` under the
    profiler, and the share of the profiled wall time with no kernel running."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with trace(log_dir, enabled=True) if log_dir else torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_start, cur_end = 0.0, None, None
    for s, e in spans:  # union of the kernels' intervals
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        busy += cur_end - cur_start
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "reps": reps,
        "wall_ms_per_call": wall_us / reps / 1e3,
        "device_busy_ms_per_call": busy / reps / 1e3,
        "idle_share": (1.0 - busy / wall_us) if wall_us else None,
        "kernel_launches_per_call": len(kernels) / reps,
        "top_kernels_ms_per_call": [[name[:120], us / reps / 1e3] for name, us in ranked[:top]],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--backbone", default=None,
                   help="zoo name (default RN50; ViT-B/32 with --train)")
    p.add_argument("--quant", default="none", choices=["none", "int8", "int8_pallas"])
    p.add_argument("--fuse_qkv", action="store_true")
    p.add_argument("--batch", type=int, default=None,
                   help="images per step (default 256; 128 with --train)")
    p.add_argument("--image_hw", type=int, default=256)
    p.add_argument("--out", default=None, help="write the profiler traces here")
    p.add_argument("--train", action="store_true",
                   help="break down a contrastive training step instead")
    p.add_argument("--attn_impl", default="pallas", choices=["pallas", "auto", "xla"],
                   help="attention of the --train model")
    p.add_argument("--remat", action="store_true", help="rematerialize blocks (--train)")
    p.add_argument("--fuse_bn", action="store_true",
                   help="image stages of the folded ResNet tower beside the unfused one")
    p.add_argument("--bottleneck", action="store_true",
                   help="kernels 8 and 9 at RN50's stride-1 block shapes")
    args = p.parse_args(argv)
    if args.batch is None:
        args.batch = 128 if args.train else 256
    if args.backbone is None:
        args.backbone = "ViT-B/32" if args.train else "RN50"

    import numpy as np
    from debiasing_multi_modal_tpu_torch.extract.runner import ExtractionRunner
    from debiasing_multi_modal_tpu_torch.models import create_clip

    if not torch.cuda.is_available():
        raise SystemExit("chip_profile.py: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]

    if args.bottleneck:
        bottleneck_profile(args.batch, card)
        return
    rng = np.random.default_rng(0)
    n, hw = args.batch, args.image_hw
    tokens = np.zeros((n, 77), np.int64)
    tokens[:, 0], tokens[:, 1:20], tokens[:, 20] = 49406, rng.integers(1, 49406, (n, 19)), 49407
    tokens = torch.from_numpy(tokens).cuda()
    if args.train:
        model = create_clip(args.backbone, dtype=torch.bfloat16, device="cuda",
                            attn_impl=args.attn_impl, remat=args.remat,
                            generator=torch.Generator().manual_seed(0)).requires_grad_(True)
        opt = torch.optim.SGD(model.parameters(), lr=1e-3)
        images = torch.from_numpy(rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)).cuda()
        head = {"card": card, "backbone": args.backbone, "attn_impl": args.attn_impl,
                "remat": args.remat, "batch": n, "image_hw": [hw, hw],
                "dtype": "bfloat16 compute, f32 params", "optimizer": "SGD"}
        stages, step = train_stages(model, opt, images, tokens)
        print(json.dumps({"profile": "train_stages_ms", **head, **stages}), flush=True)
        print(json.dumps({"profile": "train_step_kernels", **head, **kernel_breakdown(
            step, log_dir=args.out and os.path.join(args.out, "train"))}), flush=True)
        return
    model = create_clip(args.backbone, dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(0),
                        quant=args.quant, fuse_qkv=args.fuse_qkv)
    zs = rng.standard_normal((2, model.config.embed_dim)).astype(np.float32)
    runner = ExtractionRunner(model, zs)
    uploaded = runner.upload_batch(rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8))

    def text_encode():
        with torch.inference_mode():
            model.encode_text(tokens)

    head = {"card": card, "backbone": args.backbone, "quant": args.quant,
            "fuse_qkv": args.fuse_qkv, "batch": n, "image_hw": [hw, hw],
            "dtype": "bfloat16", "fuse_bn": False}
    out = args.out
    stages = vit_image_stages if model.config.is_vit else image_stages
    print(json.dumps({"profile": "image_stages_ms", **head,
                      **stages(runner, uploaded)}), flush=True)
    if args.fuse_bn:
        from debiasing_multi_modal_tpu_torch.weights.convert import clip_from_state_dict
        from debiasing_multi_modal_tpu_torch.weights.fold import fold_resnet_bn

        folded = clip_from_state_dict(
            fold_resnet_bn({k: v.cpu().numpy() for k, v in model.state_dict().items()}),
            name=args.backbone, dtype=torch.bfloat16, device="cuda", fuse_bn=True)
        f_runner = ExtractionRunner(folded, zs)
        print(json.dumps({"profile": "image_stages_ms", **head, "fuse_bn": True,
                          **image_stages(f_runner, uploaded)}), flush=True)
        print(json.dumps({"profile": "image_step_kernels", **head, "fuse_bn": True,
                          **kernel_breakdown(lambda: f_runner.encode_batch_async(uploaded),
                                             log_dir=out and os.path.join(out, "image_fused"))}),
              flush=True)
    print(json.dumps({"profile": "text_stages_ms", **head,
                      **text_stages(model, tokens)}), flush=True)
    print(json.dumps({"profile": "image_step_kernels", **head, **kernel_breakdown(
        lambda: runner.encode_batch_async(uploaded),
        log_dir=out and os.path.join(out, "image"))}), flush=True)
    print(json.dumps({"profile": "text_encode_kernels", **head, **kernel_breakdown(
        text_encode, log_dir=out and os.path.join(out, "text"))}), flush=True)


if __name__ == "__main__":
    main()
