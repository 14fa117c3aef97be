"""Profiling for the port (counterpart of ``utils/profiling.py``).

:func:`trace` records a ``torch.profiler`` trace of a region into
``log_dir`` (TensorBoard / Chrome trace format).

Run as a module, it breaks a Stage-A slice down on one card (bf16, seeded
random weights, the shapes ``chip_smoke.py`` drives):

    python -m debiasing_multi_modal_tpu_torch.utils.profiling \
        [--backbone RN50|ViT-B/32|...] [--quant none|int8|int8_pallas] \
        [--fuse_qkv] [--batch 256] [--out DIR]

- ``stages``: device time of each stage of one ``ExtractionRunner`` image
  step (ResNet: preprocess, stem, layer1-4, attention pool, zero-shot head;
  ViT: preprocess, patch embedding, attention blocks, MLP blocks, the rest of
  the transformer, the class-token head, zero-shot head) and of one text
  encode (attention blocks, MLP blocks, the rest), from CUDA events recorded
  by forward hooks; the median over repeated runs, in ms;
- ``kernels``: device time summed by kernel name under ``torch.profiler``
  over a few image steps and text encodes, with the share of the profiled
  wall time in which no kernel ran (``idle_share``).

Every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import time


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the region (host, and the card when there is one) and write
    the trace into ``log_dir``; yields the profiler (``None`` if disabled)."""
    if not enabled:
        yield None
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


def _event():
    import torch

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
    import torch

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
    import torch

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


def kernel_breakdown(fn, reps=3, top=20, log_dir=None):
    """Device time by kernel name over ``reps`` calls of ``fn`` under the
    profiler, and the share of the profiled wall time with no kernel running."""
    import torch
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
    p.add_argument("--backbone", default="RN50")
    p.add_argument("--quant", default="none", choices=["none", "int8", "int8_pallas"])
    p.add_argument("--fuse_qkv", action="store_true")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--image_hw", type=int, default=256)
    p.add_argument("--out", default=None, help="write the profiler traces here")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.extract.runner import ExtractionRunner
    from debiasing_multi_modal_tpu_torch.models import create_clip

    if not torch.cuda.is_available():
        raise SystemExit("profiling: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]

    rng = np.random.default_rng(0)
    model = create_clip(args.backbone, dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(0),
                        quant=args.quant, fuse_qkv=args.fuse_qkv)
    n, hw = args.batch, args.image_hw
    tokens = np.zeros((n, 77), np.int64)
    tokens[:, 0], tokens[:, 1:20], tokens[:, 20] = 49406, rng.integers(1, 49406, (n, 19)), 49407
    tokens = torch.from_numpy(tokens).cuda()
    runner = ExtractionRunner(
        model, rng.standard_normal((2, model.config.embed_dim)).astype(np.float32))
    uploaded = runner.upload_batch(rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8))

    def text_encode():
        with torch.inference_mode():
            model.encode_text(tokens)

    head = {"card": card, "backbone": args.backbone, "quant": args.quant,
            "fuse_qkv": args.fuse_qkv, "batch": n, "image_hw": [hw, hw],
            "dtype": "bfloat16"}
    stages = vit_image_stages if model.config.is_vit else image_stages
    print(json.dumps({"profile": "image_stages_ms", **head,
                      **stages(runner, uploaded)}), flush=True)
    print(json.dumps({"profile": "text_stages_ms", **head,
                      **text_stages(model, tokens)}), flush=True)
    out = args.out
    print(json.dumps({"profile": "image_step_kernels", **head, **kernel_breakdown(
        lambda: runner.encode_batch_async(uploaded),
        log_dir=out and os.path.join(out, "image"))}), flush=True)
    print(json.dumps({"profile": "text_encode_kernels", **head, **kernel_breakdown(
        text_encode, log_dir=out and os.path.join(out, "text"))}), flush=True)


if __name__ == "__main__":
    main()
