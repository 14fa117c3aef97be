#!/usr/bin/env python3
"""Drive the PyTorch port (debiasing_multi_modal_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order, each printing one JSON line; any failure raises and exits
nonzero, and only a run where every phase passed prints the final line.

1. device  — require CUDA; print the card's name, count and power limit
             (nvidia-smi); turn TF32 off for f32 matmuls and convolutions.
2. build   — compile every kernel under debiasing_multi_modal_tpu_torch/csrc
             with nvcc (one process per source, all started together).
3. kernels — hold each kernel against its plain PyTorch version on the card
             at the main path's shapes, and time kernel, plain version and the
             PyTorch library call that computes the same function (yardstick
             only; the port never calls it).
4. slice   — the main path at full RN50 width in bf16 with seeded random
             weights: launch counts set to 0, then the text tower encodes 256
             synthetic prompts and ExtractionRunner.encode_batch extracts a
             uint8 [256, 256, 256, 3] batch (on-device resize and crop), then
             the counts are read.  Outputs are checked (finite, in range, text
             within cosine 0.999 of the plain-attention model, f32 towers on
             the card against the CPU on a small input) and throughput timed.
5. summary — the wall seconds, one {"kernels": [...]} line, the card line, and
             {"ok": true, "device": {...}} as the last line.
"""

import json
import statistics
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense), for bound_ms.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
SEED = 0


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, runs=20, calls=20, warmup=5):
    """Device time of one call: the median over ``runs`` of CUDA events around
    ``calls`` back-to-back calls, divided by ``calls``.  The calls queue up
    behind each other, so the host's time per call hides behind the card's
    as long as it is the shorter of the two."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build():
    from debiasing_multi_modal_tpu_torch.ops import cuda_build

    seconds = cuda_build.build_all()
    emit({"phase": "build", "kernels": cuda_build.kernel_names(),
          "seconds": seconds})


def _attention_bound_ms(b, s, d, h, causal, dtype, itemsize):
    pairs = h * (s * (s + 1) // 2 if causal else s * s)  # (query, key) pairs per image
    flops = 4 * b * pairs * (d // h)                     # QK^T and PV, 2 flops per MAC
    bytes_ms = 4 * b * s * d * itemsize / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


def _attention_f64(q, k, v, h, causal):
    """The same attention in float64, as a yardstick of both versions' error."""
    import torch

    b, s, d = q.shape
    qh, kh, vh = (x.double().view(b, s, h, d // h) for x in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (d // h) ** -0.5
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), vh).reshape(b, s, d)


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from debiasing_multi_modal_tpu_torch.ops import short_attention as sa
    from debiasing_multi_modal_tpu_torch.ops.attention import multi_head_attention

    # on the card, impl="auto" is the kernel: a shape it does not take raises
    half = torch.zeros(2, 77, 512, device="cuda", dtype=torch.float16)
    try:
        multi_head_attention(half, half, half, 8, causal=True, impl="auto")
    except ValueError:
        pass
    else:
        raise AssertionError("impl='auto' ran an fp16 shape the kernel does not take")

    cases = [  # (label, B, S, D, H, causal, dtype, max abs error)
        ("text_rn50_bf16", 256, 77, 512, 8, True, torch.bfloat16, 2e-2),
        ("text_rn50_f32", 256, 77, 512, 8, True, torch.float32, 1e-5),
        ("ragged_noncausal_bf16", 5, 50, 768, 12, False, torch.bfloat16, 2e-2),
        ("ragged_noncausal_f32", 5, 50, 768, 12, False, torch.float32, 1e-5),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for label, b, s, d, h, causal, dtype, tol in cases:
        q, k, v = (torch.randn(b, s, d, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        out = sa.short_attention(q, k, v, h, causal=causal)
        torch.cuda.synchronize()
        ref = sa.short_attention_reference(q, k, v, h, causal)
        err = (out.float() - ref.float()).abs().max().item()
        cos = F.cosine_similarity(out.float().flatten(), ref.float().flatten(), dim=0).item()
        exact = _attention_f64(q, k, v, h, causal)
        row = {"case": label, "shape": [b, s, d, h], "causal": causal,
               "dtype": str(dtype), "max_abs_err": err, "tolerance": tol,
               "cosine": cos,
               "kernel_err_vs_f64": (out.double() - exact).abs().max().item(),
               "plain_err_vs_f64": (ref.double() - exact).abs().max().item()}
        if not (err <= tol and (dtype == torch.float32 or cos >= 0.9999)):
            raise AssertionError(f"short_attention disagrees with its plain version: {row}")
        if label == "text_rn50_bf16":
            heads = [x.view(b, s, h, d // h).transpose(1, 2) for x in (q, k, v)]
            row["ms"] = time_ms(lambda: sa.short_attention(q, k, v, h, causal=causal))
            row["plain_ms"] = time_ms(lambda: sa.short_attention_reference(q, k, v, h, causal))
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(*heads, is_causal=causal))
            row["bound_ms"], row["bound_by"] = _attention_bound_ms(
                b, s, d, h, causal, dtype, q.element_size())
        emit({"phase": "kernels", **row})
        results.append(row)
    return results


def _tokens(n, rng):
    import numpy as np

    toks = np.zeros((n, 77), np.int32)
    toks[:, 0] = 49406  # <|startoftext|>
    for i in range(n):
        end = int(rng.integers(4, 40))
        toks[i, 1:end] = rng.integers(1, 49406, end - 1)
        toks[i, end] = 49407  # <|endoftext|>
    return toks


def phase_slice():
    import numpy as np
    import torch
    import torch.nn.functional as F

    from debiasing_multi_modal_tpu_torch.extract.runner import ExtractionRunner
    from debiasing_multi_modal_tpu_torch.models import create_clip
    from debiasing_multi_modal_tpu_torch.ops import short_attention as sa

    def seeded():
        return torch.Generator().manual_seed(SEED)

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    model = create_clip("RN50", dtype=torch.bfloat16, device="cuda", generator=seeded())
    setup_s = time.perf_counter() - t0
    tokens = torch.from_numpy(_tokens(256, rng)).cuda()
    images = rng.integers(0, 256, (256, 256, 256, 3), dtype=np.uint8)

    # ---- the main path, with every launch count at 0 just before it
    sa.short_attention.launches = 0
    with torch.inference_mode():
        text = model.encode_text(tokens)
    runner = ExtractionRunner(model, text[:2].float().cpu().numpy())
    emb, preds = runner.encode_batch(images)
    torch.cuda.synchronize()
    launches = {"short_attention": sa.short_attention.launches}
    # ----
    layers = model.config.transformer_layers
    if launches["short_attention"] != layers:
        raise AssertionError(f"expected {layers} short_attention launches, got {launches}")
    text32 = text.float()
    if not (torch.isfinite(text32).all() and text32.shape == (256, 1024)):
        raise AssertionError("text embeddings are not finite [256, 1024]")
    if not (np.isfinite(emb).all() and emb.shape == (256, 1024)):
        raise AssertionError("image embeddings are not finite [256, 1024]")
    if not (preds.shape == (256,) and preds.min() >= 0 and preds.max() < 2):
        raise AssertionError("zero-shot predictions out of range")

    # the same weights with the plain attention formulation
    plain = create_clip("RN50", dtype=torch.bfloat16, attn_impl="xla", device="cuda",
                        generator=seeded())
    with torch.inference_mode():
        text_plain = plain.encode_text(tokens).float()
    text_cos = F.cosine_similarity(text32, text_plain, dim=-1).min().item()
    if text_cos < 0.999:
        raise AssertionError(f"kernel text path vs plain attention: min cosine {text_cos}")
    del plain

    # f32 towers on the card (kernel attention, TF32 off) against the CPU
    small_imgs = rng.integers(0, 256, (4, 224, 224, 3), dtype=np.uint8)
    small_toks = tokens[:4].cpu()
    cuda32 = create_clip("RN50", device="cuda", generator=seeded())
    cpu32 = create_clip("RN50", device="cpu", generator=seeded())
    zs = text[:2].float().cpu().numpy()
    emb_cuda, _ = ExtractionRunner(cuda32, zs).encode_batch(small_imgs)
    emb_cpu, _ = ExtractionRunner(cpu32, zs).encode_batch(small_imgs)
    with torch.inference_mode():
        txt_cuda = cuda32.encode_text(small_toks.cuda()).cpu().numpy()
        txt_cpu = cpu32.encode_text(small_toks).numpy()
    emb_bf16, _ = runner.encode_batch(small_imgs)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    def cos_min(a, b):
        a, b = torch.from_numpy(a), torch.from_numpy(b)
        return F.cosine_similarity(a, b, dim=-1).min().item()

    checks = {"image_f32_cuda_vs_cpu_rel": rel(emb_cuda, emb_cpu),
              "text_f32_cuda_vs_cpu_rel": rel(txt_cuda, txt_cpu),
              "image_bf16_vs_f32_min_cosine": cos_min(emb_bf16, emb_cuda),
              "text_kernel_vs_plain_bf16_min_cosine": text_cos}
    if not (checks["image_f32_cuda_vs_cpu_rel"] <= 1e-3
            and checks["text_f32_cuda_vs_cpu_rel"] <= 1e-3
            and checks["image_bf16_vs_f32_min_cosine"] >= 0.99):
        raise AssertionError(f"tower outputs disagree: {checks}")
    del cuda32, cpu32

    # throughput (host clock around synchronized work)
    def rate(fn, items, reps):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return items * reps / (time.perf_counter() - t)

    def text_encode():
        with torch.inference_mode():
            model.encode_text(tokens)

    uploaded = runner.upload_batch(images)
    metas = [{"filenames": np.array([f"{b}_{i}" for i in range(256)]),
              "y": np.zeros(256, np.int32), "place": np.zeros(256, np.int32),
              "group": np.zeros(256, np.int32), "split": np.zeros(256, np.int32)}
             for b in range(8)]
    stream = [(rng.integers(0, 256, images.shape, dtype=np.uint8), m) for m in metas]
    t = time.perf_counter()
    table = runner.run(iter(stream))
    run_imgs_s = len(table) / (time.perf_counter() - t)
    prompts_per_s = rate(text_encode, 256, 10)
    perf = {
        "prompts_per_s": prompts_per_s,
        "imgs_per_s_device": rate(lambda: runner.encode_batch_async(uploaded), 256, 10),
        "imgs_per_s_encode_batch": rate(lambda: runner.encode_batch(images), 256, 5),
        "imgs_per_s_run_8_batches": run_imgs_s,
        "text_encode_ms": 256 / prompts_per_s * 1e3,
    }
    emit({"phase": "slice", "model": "RN50", "dtype": "bfloat16", "batch": 256,
          "image_hw": [256, 256], "launches": launches, "checks": checks,
          "perf": perf, "model_setup_s": setup_s})
    return launches


def main():
    t0 = time.perf_counter()
    info = phase_device()
    phase_build()
    cases = phase_kernels()
    launches = phase_slice()
    main_case = next(c for c in cases if c["case"] == "text_rn50_bf16")
    emit({"phase": "summary", "seconds": time.perf_counter() - t0})
    emit({"kernels": [{
        "name": "short_attention",
        "route": "cuda",
        "source": "debiasing_multi_modal_tpu_torch/csrc/short_attention.cu",
        "replaces": "debiasing_multi_modal_tpu/ops/short_attention.py:218",
        "launches": launches["short_attention"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "kernel_ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": main_case["shape"],
        "card": info["nvidia_smi"],
    }]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
