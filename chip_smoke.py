#!/usr/bin/env python3
"""Drive the PyTorch port (debiasing_multi_modal_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only flash_f32   # the timed f32 flash cases and the
                                             # f32 training step alone
    python3 chip_smoke.py --only rn50_blocks # kernels 8 and 9 at the folded RN50's
                                             # stride-1 blocks alone
    python3 chip_smoke.py --only stage_b     # Stage B (adapter training) alone

Phases, in order, each printing one JSON line per case; any failure raises
and exits nonzero, and only a run where every phase passed prints the final
line.

1. device  — require CUDA; print the card's name, count and power limit
             (nvidia-smi); turn TF32 off for f32 matmuls and convolutions.
2. build   — compile every kernel under debiasing_multi_modal_tpu_torch/csrc
             with nvcc (one process per source, all started together); print
             the registers and spills of kernels 1-3, of every flash
             instantiation, of kernel 7 and of kernels 8-9 (-Xptxas=-v); bf16
             kernel 4 must not spill at hd 32, 64 and 128, f32 kernel 4 and
             kernels 5 and 6 (bf16 and f32) at hd 32 and 64, kernel 7 and the
             bf16 (tensor-core) instantiations of kernels 8-9 at all, f32
             kernels 1-3 (every tile) at hd 32 and 64.
3. kernels — hold each kernel against its plain PyTorch version on the card
             at the main paths' shapes, and time kernel, plain version and the
             PyTorch library call that computes the same function (yardstick
             only; the port never calls it): kernel 1 (whole-row attention;
             bf16 on the tensor cores, timed at the text and ViT-B/32 image
             shapes, f32 on the CUDA cores, register-tiled, at the RN50 and
             ViT-L/14@336px text shapes and the ViT-L/14 image shape; the attention
             kernels, their plain versions and SDPA timed by CUDA-graph replay,
             so a wrapper's host time stays out), kernel 2
             (q-tiled; f32 the same register-tiled code with K/V streamed;
             bf16, on no main path, timed at ViT-L/14@448's S=1025),
             kernel 3 (packed, timed at both shapes), with ragged
             bf16 S from 1 to the gate's largest (832 at hd 64) for kernels 1
             and 3, ragged f32 S from 1 to each gate's largest (348 and 1,624
             at hd 64; 592 / 1,720 at hd 32, 184 / 1,432 at hd 128) for
             kernels 1, 3 and 2, and the order checks (kernel 3 bit-equal to kernel 1 in
             both dtypes, kernel 2 bit-equal to kernel 1 in f32 and within the
             bf16 limits in bf16), kernel 7 (int8 GEMM on wgmma fed by TMA,
             at the three ViT-B/32 int8_pallas shapes, timed by graph replay
             with the event time beside, against torch._int_mm alone and
             torch._int_mm with the plain epilogue, and the host cost of one
             activation tensor map), and
             kernels 4, 5, 6 (flash forward, dQ, dK/dV; all three on the
             tensor cores, bf16 as such, f32 as split-TF32) at the training
             step's two shapes in both dtypes, a long
             shape (bf16 S=4096, plain and causal; f32 S=2048), ragged cross
             shapes and hd=32 and hd=128, timed by CUDA-graph replay with the
             event time beside (SDPA, forward and backward, as yardsticks; its
             backward alone, autograd's backward captured in the graph); the
             delta pass timed beside kernels 5 and 6, and in f32 the backend
             SDPA takes (each backend forced in turn, compared bit for bit).
4. slice   — RN50 at full width in bf16 with seeded random weights: launch
             counts set to 0, then the text tower encodes 256 synthetic
             prompts and ExtractionRunner.encode_batch extracts a uint8
             [256, 256, 256, 3] batch (on-device resize and crop), then the
             counts are read.  Outputs are checked (finite, in range, text
             within cosine 0.999 of the plain-attention model, f32 towers on
             the card against the CPU on a small input, the one-pass
             BatchNorm against the JAX formula at RN50's five widths within
             one bf16 rounding at scale) and throughput timed,
             the host's load average beside it.  Then one encode_batch_async
             on an uploaded batch under torch.cuda.set_sync_debug_mode("error"):
             the step must not make the host wait for the card.
5. fuse_bn — RN50 at full width in bf16 with its BatchNorms folded
             (weights/fold.py): seeded weights whose visual BatchNorm
             statistics are made non-trivial from the seed (mean ~ N(0, 0.2^2),
             var ~ U(0.5, 2)), folded into a fuse_bn model, then the same drive
             as the slice with the counts set to 0 before it (kernel 1: 12;
             the model calls neither bottleneck kernel, as in the JAX
             package).  Image embeddings within cosine 0.999 of the unfused
             model's, zero-shot predictions equal on >= 99 % of the images, the
             f32 folded tower on the card against the CPU; throughput beside
             the unfused model's.
6. rn50_blocks — every stride-1 block of the folded RN50 (batch 256, bf16),
             its input captured by hooks from the folded tower's forward:
             with the counts set to 0, kernel 8 on all 13 (the downsample on
             layer1.0, the gate's largest strip) and kernel 9 on the 12
             identity blocks; each output held to xla_bottleneck (<= 2e-2 of
             scale, cosine >= 0.9999; f32 on one block <= 1e-4 of scale) and
             to the model's own Bottleneck.forward (cosine >= 0.999); kernel,
             plain and model-block times at l1b0_ds, l1b1, l2b1, l3b1, l4b1
             (bf16: mma.sync on the tensor cores); f32 (CUDA-core FMAs, on no
             main path) at l2b1 on 8 images, timed beside the plain version
             and the model's block run in f32.
7. vit     — ViT-B/32 at full width and depth in bf16, the same drive three
             times with the counts set to 0 before each: unfused (kernel 1),
             fuse_qkv=True (kernel 3) and quant="int8_pallas" (kernel 7 and
             kernel 1); both towers checked against the plain-attention
             model, fuse_qkv against unfused, int8_pallas against bf16 and
             against quant="int8" (torch._int_mm), f32 on the card against
             the CPU, and throughput with the host's load beside it; one
             encode_batch_async under the sync check.
8. qtiled  — ViT-L/14@336px at its zoo default f32 encodes four 336x336
             images through kernel 2 and 256 prompts through f32 kernel 1
             (counts 24 and 12), both towers held to the same weights under
             the plain attention formulation; image ms and prompts/s.
9. train   — ViT-B/32 at full width and depth, bf16 compute, f32 parameters,
             attn_impl="pallas": 3 SGD steps of the symmetric contrastive loss
             on 128 uint8 images (preprocessed on the card) and 128 prompts,
             with every launch count at 0 before the first step and read
             after it (kernels 4, 5, 6: 24 each), then the same step with
             remat=True (48/24/24), under "xla" and under "auto" (kernel 1
             forward, the plain VJP backward); the gradients are checked
             against "xla", remat against plain, and an f32 step on 4 pairs
             against the CPU; one whole step (preprocess, forward, backward,
             SGD) under torch.cuda.set_sync_debug_mode("error"); the step's
             time and pairs per second.  Then the step in f32, the JAX
             package's default dtype, on all 128 pairs (kernels 4, 5, 6: 24
             each, all split-TF32), finite, under the same sync check, and
             its time.
10. stage_b — Stage B, the adapter training that gives the worst-group
             accuracy (no kernel of the port runs there: the JAX package's
             Stage B is XLA only): the flagship configuration of
             scripts/run_final_main.sh (adapter_reg_seq_alter --add_adapter
             --warm_reg, bs 1024, bsr 256, lr 1.0, lrr 1.0, decay 0.1) on an
             RN50-width (D=1024) synthetic cache from SEED with the Waterbirds
             split sizes (4,795 / 1,199 / 5,794), epochs cut to 6 with the
             phase switch after 3; train_all_epochs on the card with the
             counts set to 0 (all stay 0), then on the CPU from the same
             initial state, each run checkpointing every epoch to a
             temporary directory: the ep00001 checkpoint (parameters, BatchNorm
             statistics, trace) within 1e-4 of each tensor's scale, the final
             one (the frozen old_cls branch's drifting statistics included)
             within FINAL_STATE_LIMIT, every per-epoch accuracy within 5e-3,
             the selected test worst-group accuracy within 1e-2.  Then one train_epoch at
             CelebA scale (162,770 x 1024 rows on the card, batch 128, 1,272
             steps; the plan's upload included) under
             torch.cuda.set_sync_debug_mode("error"): ms, rows/s, launches
             per step (profiler), and one eval_epoch over 19,867 rows; then
             cli/train_main.py --device cuda on the flagship caches written to
             a temporary directory.
11. summary — the wall seconds, one {"kernels": [...]} line, the card line, and
             {"ok": true, "device": {...}} as the last line.
"""

import argparse
import contextlib
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense), for bound_ms.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
PEAK_TF32_FLOPS = 495e12  # f32 kernels 4-6: three TF32 products per product
PEAK_INT8_OPS = 1979e12
SEED = 0
BF16_ULP = 2.0 ** -8


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


def graph_ms(fn, runs=20, calls=20, warmup=5, stream=None):
    """Device time of one call with the host out of the way: ``calls`` calls
    captured once in a CUDA graph, then :func:`time_ms` of its replay,
    divided by ``calls``.  A kernel of a few tens of microseconds is shorter
    than its Python wrapper's host time on a loaded host, where
    :func:`time_ms` would time the host.  ``stream`` is the side stream to
    warm up and capture on (a fresh one by default)."""
    import torch

    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, runs=runs, calls=1, warmup=2) / calls
    del graph
    return ms


@contextlib.contextmanager
def no_host_sync():
    """Raise if the region makes the host wait for the card (a pageable copy,
    ``.item()``, a synchronize): ``torch.cuda.set_sync_debug_mode("error")``."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


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


def phase_build(check=True):
    """Build every kernel; with ``check``, print and check registers and
    spills."""
    from debiasing_multi_modal_tpu_torch.ops import cuda_build

    seconds = cuda_build.build_all()
    emit({"phase": "build", "kernels": cuda_build.kernel_names(),
          "seconds": seconds})
    if not check:
        return
    # registers and spills of kernels 1-3, of every flash instantiation, of
    # kernel 7 and of kernels 8-9 (nvcc -Xptxas=-v)
    short = cuda_build.ptxas_usage("short_attention")
    emit({"phase": "build", "ptxas": "short_attention.cu", "functions": short})
    qtiled = cuda_build.ptxas_usage("short_attention_qtiled")
    emit({"phase": "build", "ptxas": "short_attention_qtiled.cu", "functions": qtiled})
    flash = cuda_build.ptxas_usage("flash_attention")
    emit({"phase": "build", "ptxas": "flash_attention.cu", "functions": flash})
    gemm = cuda_build.ptxas_usage("quant_gemm")
    emit({"phase": "build", "ptxas": "quant_gemm.cu", "functions": gemm})
    block = cuda_build.ptxas_usage("bottleneck")
    emit({"phase": "build", "ptxas": "bottleneck.cu", "functions": block})
    # bf16 kernel 4 at every hd, f32 kernel 4 and bf16 and f32 kernels 5-6
    # at hd 32/64 (f32 all split-TF32), kernel 7, every f32 kernel-1
    # (resident) and kernel-2 (streamed) tile at hd 32/64, and the three bf16
    # instantiations of kernels 8-9
    must_not_spill = (r"fwd_tc_kernelILi(32|64|128)E|(fwd|dq|dkv)_f32tc_kernelILi(32|64)E"
                      r"|(dq|dkv)_tc_kernelILi(32|64)E|int8_gemm|f32_attn_kernelILi(32|64)E"
                      r"|bottleneck_tc_kernel")
    checked = [row for row in short + qtiled + flash + gemm + block
               if re.search(must_not_spill, row["function"])]
    libs = {"short_attention", "short_attention_qtiled", "flash_attention", "quant_gemm",
            "bottleneck"}
    if libs - set(cuda_build.build_logs):
        emit({"phase": "build", "ptxas": "libraries built by an earlier run: not re-read"})
    elif len(checked) != 3 + 6 + 4 + 2 + 2 * (2 + 3) + 3:
        raise AssertionError(f"expected 28 no-spill instantiations, found {len(checked)}")
    spilled = [row["function"] for row in checked
               if row.get("spill_store_bytes") or row.get("spill_load_bytes")]
    if spilled:
        raise AssertionError(f"kernels that must not spill registers do: {spilled}")


def _attention_bound_ms(b, s, d, h, causal, dtype, itemsize):
    pairs = h * (s * (s + 1) // 2 if causal else s * s)  # (query, key) pairs per image
    flops = 4 * b * pairs * (d // h)                     # QK^T and PV, 2 flops per MAC
    bytes_ms = 4 * b * s * d * itemsize / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


def _int8_bound_ms(m, k, n, out_itemsize, with_bias):
    """Each input read once (int8 operands, f32 scales and bias), the output
    written once; 2*M*N*K integer operations at the dense int8 peak."""
    nbytes = m * k + k * n + 4 * (m + n + (n if with_bias else 0)) + m * n * out_itemsize
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * m * n * k / PEAK_INT8_OPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def _attention_f64(q, k, v, h, causal):
    """The same attention in float64, as a yardstick of both versions' error."""
    import torch

    b, s, d = q.shape
    qh, kh, vh = (x.double().reshape(b, s, h, d // h) for x in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (d // h) ** -0.5
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), vh).reshape(b, s, d)


def _heads(x, h):
    """[B, S, D] (possibly a column slice) -> [B, H, S, hd] for SDPA."""
    b, s, d = x.shape
    return x.unflatten(-1, (h, d // h)).transpose(1, 2)


def _attention_case(kernel, plain, label, b, s, d, h, causal, dtype, tol, gen,
                    timed, packed=False):
    """One attention kernel against its plain version (and float64); timed
    cases add the kernel's, the plain version's and SDPA's times."""
    import torch
    import torch.nn.functional as F

    if packed:
        qkv = torch.randn(b, s, 3 * d, device="cuda", generator=gen).to(dtype)
        q, k, v = qkv.chunk(3, dim=-1)
        args = (qkv, h)
    else:
        q, k, v = (torch.randn(b, s, d, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        args = (q, k, v, h)
    out = kernel(*args, causal=causal)
    torch.cuda.synchronize()
    ref = plain(*args, causal)
    err = (out.float() - ref.float()).abs().max().item()
    cos = F.cosine_similarity(out.float().flatten(), ref.float().flatten(), dim=0).item()
    exact = _attention_f64(q, k, v, h, causal)
    row = {"case": label, "shape": [b, s, d, h], "causal": causal,
           "dtype": str(dtype), "max_abs_err": err, "tolerance": tol,
           "cosine": cos,
           "kernel_err_vs_f64": (out.double() - exact).abs().max().item(),
           "plain_err_vs_f64": (ref.double() - exact).abs().max().item()}
    del exact
    if not (err <= tol and (dtype == torch.float32 or cos >= 0.9999)):
        raise AssertionError(f"{kernel.__name__} disagrees with its plain version: {row}")
    if timed:
        # device times by CUDA-graph replay; "events_ms" is the kernel timed
        # as earlier runs timed it, with its wrapper's host time behind it
        heads = [_heads(x, h) for x in (q, k, v)]
        row["ms"] = graph_ms(lambda: kernel(*args, causal=causal))
        row["events_ms"] = time_ms(lambda: kernel(*args, causal=causal))
        row["plain_ms"] = graph_ms(lambda: plain(*args, causal))
        row["library_ms"] = graph_ms(
            lambda: F.scaled_dot_product_attention(*heads, is_causal=causal))
        row["library_call"] = "torch.nn.functional.scaled_dot_product_attention"
        row["bound_ms"], row["bound_by"] = _attention_bound_ms(
            b, s, d, h, causal, dtype, q.element_size())
    emit({"phase": "kernels", "kernel": kernel.__name__, **row})
    return row


# Ragged bf16 S at hd 64 for kernels 1 and 3: one key chunk in registers (1,
# 17, 50, 77), two passes over 64-key chunks (129, 257, 577), and the gate's
# largest S (832); causal and not.
RAGGED_S = [(f"ragged_s{s}_{'causal' if causal else 'noncausal'}_bf16", 3, s, 512, 8, causal)
            for s in (1, 17, 50, 77, 129, 257, 577, 832) for causal in (False, True)]


# Ragged f32 S at hd 64 (D=512, H=8), causal and not: kernels 1 and 3 up to
# their gate's largest S (348), kernel 2 at every S up to its gate's (1,624).
RAGGED_F32_S = (1, 31, 33, 63, 65, 129, 348, 417, 418, 1111, 1624)
RAGGED_F32 = [(f"ragged_s{s}_{'causal' if causal else 'noncausal'}_f32", 3, s, 512, 8, causal)
              for s in RAGGED_F32_S for causal in (False, True)]


def _order_checks(gen):
    """Kernel 3 runs kernel 1's device code, so the two are bit-equal in both
    dtypes; kernel 2 sums in kernel 1's f32 order (bit-equal in f32), while
    bf16 kernel 1 runs on the tensor cores, so there kernel 2 is held to the
    bf16 limits (2e-2, cosine >= 0.9999).  Comparison launches, not counted
    as the main path's."""
    import torch
    import torch.nn.functional as F

    from debiasing_multi_modal_tpu_torch.ops import short_attention as sa

    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v = (torch.randn(64, 77, 512, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        k1 = sa.short_attention(q, k, v, 8, causal=True)
        k2 = sa.short_attention_qtiled(q, k, v, 8, causal=True)
        k3 = sa.short_attention_packed(torch.cat([q, k, v], -1), 8, causal=True)
        checks[f"packed_equals_whole_row_{name}"] = torch.equal(k3, k1)
        if dtype == torch.float32:
            checks["qtiled_equals_whole_row_float32"] = torch.equal(k2, k1)
        else:
            err = (k2.float() - k1.float()).abs().max().item()
            cos = F.cosine_similarity(k2.float().flatten(), k1.float().flatten(), dim=0).item()
            checks.update(qtiled_vs_whole_row_bfloat16_max_abs=err,
                          qtiled_vs_whole_row_bfloat16_cosine=cos,
                          qtiled_within_bf16_limits_of_whole_row=err <= 2e-2 and cos >= 0.9999)
    bad = [key for key, val in checks.items() if val is False]
    if bad:
        raise AssertionError(f"kernels 1-3 disagree: {bad} {checks}")
    return checks


def _int8_case(label, m, k, n, with_bias, out_dtype, gen, timed):
    """Kernel 7 against its plain version (exact integer product, the same
    roundings: they may differ only where float64's rounding of the fused
    bias add lands on an f32 tie, so the tolerance is one ulp of the output
    dtype at the output's scale).  Timed cases: kernel, plain version and
    the two library yardsticks by graph replay (a ~0.05 ms kernel is shorter
    than its wrapper's host time), the kernel's event time beside, and the
    host cost of encoding one activation tensor map."""
    import ctypes

    import torch

    from debiasing_multi_modal_tpu_torch.ops import quant_gemm as qg
    from debiasing_multi_modal_tpu_torch.ops.quant import (
        quantize_cols_int8,
        quantize_rows_int8,
    )

    x = torch.randn(m, k, device="cuda", generator=gen)
    w = torch.randn(n, k, device="cuda", generator=gen).t()  # a Linear weight's view
    bias = torch.randn(n, device="cuda", generator=gen) if with_bias else None
    qx, sx = quantize_rows_int8(x)
    qk, sk = quantize_cols_int8(w)
    out = qg.int8_matmul(qx, qk, sx, sk, bias, out_dtype=out_dtype)
    torch.cuda.synchronize()
    ref = qg.int8_matmul_reference(qx, qk, sx, sk, bias, out_dtype=out_dtype)
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = scale * (BF16_ULP if out_dtype == torch.bfloat16 else 2.0 ** -23)
    row = {"case": label, "shape": [m, k, n], "bias": with_bias,
           "out_dtype": str(out_dtype), "max_abs_err": err, "tolerance": tol,
           "bit_equal": bool(torch.equal(out, ref))}
    if not err <= tol:
        raise AssertionError(f"int8_matmul disagrees with its plain version: {row}")
    if timed:
        from debiasing_multi_modal_tpu_torch.ops import cuda_build

        def kernel():
            return qg.int8_matmul(qx, qk, sx, sk, bias, out_dtype=out_dtype)

        row["ms"] = graph_ms(kernel)
        row["events_ms"] = time_ms(kernel)
        row["plain_ms"] = graph_ms(
            lambda: qg.int8_matmul_reference(qx, qk, sx, sk, bias, out_dtype=out_dtype))
        row["library_ms"] = graph_ms(lambda: torch._int_mm(qx, qk))
        row["library_call"] = "torch._int_mm (the integer product alone, no epilogue)"
        row["library2_ms"] = graph_ms(lambda: qg.dequantize(
            torch._int_mm(qx, qk), sx, sk, bias, fused=False).to(out_dtype))
        row["library2_call"] = ("torch._int_mm + the plain epilogue (quant='int8' on the "
                                "card)")
        encode = cuda_build.library("quant_gemm").int8_matmul_encode_us
        encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        encode.restype = ctypes.c_double
        row["tensor_map_encode_us"] = encode(qx.data_ptr(), m, k, 1000)
        row["bound_ms"], row["bound_by"] = _int8_bound_ms(
            m, k, n, out.element_size(), with_bias)
    emit({"phase": "kernels", "kernel": "int8_matmul", **row})
    return row


def phase_kernels():
    import torch

    from debiasing_multi_modal_tpu_torch.ops import flash_attention as fa
    from debiasing_multi_modal_tpu_torch.ops import short_attention as sa
    from debiasing_multi_modal_tpu_torch.ops.attention import multi_head_attention

    # on the card, impl="auto" is a kernel: a shape none takes raises, and
    # one past kernels 1 and 2 splits its heads and takes kernel 4
    half = torch.zeros(2, 77, 512, device="cuda", dtype=torch.float16)
    try:
        multi_head_attention(half, half, half, 8, causal=True, impl="auto")
    except ValueError:
        pass
    else:
        raise AssertionError("impl='auto' ran an fp16 shape, which no kernel takes")
    too_long = torch.zeros(1, 2048, 512, device="cuda", dtype=torch.bfloat16)
    before = fa.flash_attention.launches
    multi_head_attention(too_long, too_long, too_long, 8, causal=True, impl="auto")
    if fa.flash_attention.launches != before + 1:
        raise AssertionError("impl='auto' at bf16 S=2048 did not launch kernel 4 once")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    ragged = [(*case, bf16, 2e-2, False) for case in RAGGED_S]
    results = {"short_attention": [], "short_attention_qtiled": [],
               "short_attention_packed": [], "int8_matmul": []}
    # (label, B, S, D, H, causal, dtype, max abs error, timed); bf16 runs on
    # the tensor cores, f32 on the CUDA cores
    ragged32 = [(*case, f32, 1e-5, False) for case in RAGGED_F32]
    whole32 = [case for case in ragged32 if case[2] <= 348]  # kernel 1's gate at hd 64
    for case in [("text_rn50_bf16", 256, 77, 512, 8, True, bf16, 2e-2, True),
                 ("text_rn50_f32", 256, 77, 512, 8, True, f32, 1e-5, True),
                 ("vitb32_image_bf16", 256, 50, 768, 12, False, bf16, 2e-2, True),
                 ("vitl14_image_f32", 64, 257, 1024, 16, False, f32, 1e-5, True),
                 ("text_vitl14_336_f32", 256, 77, 768, 12, True, f32, 1e-5, True),
                 ("ragged_noncausal_bf16", 5, 50, 768, 12, False, bf16, 2e-2, False),
                 ("ragged_noncausal_f32", 5, 50, 768, 12, False, f32, 1e-5, False),
                 ("gate_largest_hd32_f32", 2, 592, 256, 8, False, f32, 1e-5, False),
                 ("gate_largest_hd128_f32", 2, 184, 512, 4, True, f32, 1e-5, False),
                 *ragged, *whole32]:
        results["short_attention"].append(_attention_case(
            sa.short_attention, sa.short_attention_reference, *case[:8], gen, case[8]))
    for case in [("vitl14_336_f32", 8, 577, 1024, 16, False, f32, 1e-5, True),
                 # bf16 kernel 2, on no main path, timed for the record
                 ("vitl14_448_bf16", 4, 1025, 1024, 16, False, bf16, 2e-2, True),
                 ("ragged_causal_f32", 3, 1111, 256, 4, True, f32, 1e-5, False),
                 ("gate_largest_hd32_f32", 2, 1720, 256, 8, False, f32, 1e-5, False),
                 ("gate_largest_hd128_f32", 2, 1432, 512, 4, True, f32, 1e-5, False),
                 *ragged32]:
        results["short_attention_qtiled"].append(_attention_case(
            sa.short_attention_qtiled, sa.short_attention_reference, *case[:8], gen,
            case[8]))
    for case in [("vitb32_packed_bf16", 256, 50, 768, 12, False, bf16, 2e-2, True),
                 ("text_packed_bf16", 256, 77, 512, 8, True, bf16, 2e-2, True),
                 *ragged, *whole32]:
        results["short_attention_packed"].append(_attention_case(
            sa.short_attention_packed, sa.short_attention_packed_reference, *case[:8],
            gen, case[8], packed=True))
    emit({"phase": "kernels", "check": "kernel_order", **_order_checks(gen)})
    # every shape the ViT-B/32 int8_pallas path launches, each timed:
    # c_fc, q/k/v/out_proj, c_proj; then ragged M with K = 588 (padded to 640)
    for case in [("vitb32_c_fc_bf16", 12800, 768, 3072, True, bf16, True),
                 ("vitb32_qkv_out_bf16", 12800, 768, 768, True, bf16, True),
                 ("vitb32_c_proj_bf16", 12800, 3072, 768, True, bf16, True),
                 ("vitb32_c_fc_f32_no_bias", 12800, 768, 3072, False, f32, False),
                 ("ragged_m_unaligned_k_f32", 1000, 588, 256, False, f32, False),
                 ("ragged_m_unaligned_k_bias_bf16", 1000, 588, 256, True, bf16, False)]:
        results["int8_matmul"].append(_int8_case(*case[:6], gen, case[6]))
    results.update(_flash_cases(gen))
    return results


def _flash_bounds(b, sq, skv, h, hd, causal, dtype, itemsize):
    """bound_ms and what bounds it, per kernel: the (query, key) pairs this
    run's mask keeps; 4, 6 and 8 flops per pair and head dim (two, three and
    four products); each tensor read or written once (lse and delta f32).
    f32 kernels 4, 5 and 6 run each product as three TF32 products: their
    operations bound is 3x the flops at the TF32 peak.  Also returns, per
    kernel, the bound at the dtype's PEAK_FLOPS, in f32 the CUDA cores' FMA
    peak (the f32 kernels' route before PRs 9-10)."""
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    pairs *= b * h
    q_el, kv_el, stats = b * sq * h * hd, b * skv * h * hd, 4 * b * h * sq
    work = {"flash_attention": (4, 2 * q_el + 2 * kv_el, 1),        # q, k, v, out; lse
            "flash_attention_dq": (6, 3 * q_el + 2 * kv_el, 2),     # q, dO, dq, k, v; lse, delta
            "flash_attention_dkv": (8, 2 * q_el + 4 * kv_el, 2)}    # q, dO, k, v, dk, dv
    out, at_peak = {}, {}
    for name, (flops_per, elements, n_stats) in work.items():
        bytes_ms = (elements * itemsize + n_stats * stats) / HBM_BYTES_PER_S * 1e3
        flops = flops_per * pairs * hd
        flops_ms = flops / PEAK_FLOPS[str(dtype)] * 1e3
        at_peak[name] = max(bytes_ms, flops_ms)
        if str(dtype) == "torch.float32":
            flops_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
        out[name] = (max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations")
    return out, at_peak


def _close(out, ref, dtype):
    """max |kernel - plain|, the plain version's scale, cosine, and whether
    they agree: bf16 within 1e-2 of scale and cosine >= 0.9999 (bf16
    roundings of p and ds land on either side where f32 sums differ in
    order); f32 within 1e-4 of scale (sums over up to 4096 terms in another
    order)."""
    import torch
    import torch.nn.functional as F

    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    cos = F.cosine_similarity(out.float().flatten(), ref.float().flatten(), dim=0).item()
    ok = (err <= 1e-2 * scale and cos >= 0.9999) if dtype == torch.bfloat16 else (
        err <= 1e-4 * scale)
    return {"max_abs_err": err, "scale": scale, "cosine": cos}, ok


def _sdpa_backward_ms(heads, dout, causal, fast):
    """SDPA's backward alone (dq, dk, dv from a retained graph) by graph
    replay: the forward runs on the capture stream, so autograd runs the
    backward there and the capture takes it."""
    import torch
    import torch.nn.functional as F

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [x.detach().requires_grad_() for x in heads]
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    torch.cuda.current_stream().wait_stream(side)

    def backward():
        return torch.autograd.grad(out, leaves, dout, retain_graph=True)

    return graph_ms(backward, stream=side, **fast)


def _sdpa_backend(heads, dout, causal):
    """Which backend SDPA takes here: its outputs and gradients by default,
    then under ``torch.nn.attention.sdpa_kernel`` with each backend in turn
    (the largest gap to the default, or "not available"); the backends whose
    results equal the default's bit for bit; and the attention kernels the
    profiler names in one default forward and backward."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def run():
        leaves = [x.detach().requires_grad_() for x in heads]
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        return (out.detach(), *torch.autograd.grad(out, leaves, dout))

    default = run()
    gaps = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")
                got = run()
        except RuntimeError:
            gaps[backend.name] = "not available"
            continue
        gaps[backend.name] = max((a - b).abs().max().item() for a, b in zip(got, default))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    words = ("fmha", "attention", "attn", "flash", "cudnn", "efficient")
    names = sorted({e.key for e in prof.key_averages() if any(w in e.key.lower() for w in words)})
    return {"sdpa_backend": [name for name, gap in gaps.items() if gap == 0.0],
            "sdpa_backend_gaps": gaps, "sdpa_kernels": [n[:120] for n in names[:6]]}


def _flash_case(label, b, sq, skv, h, hd, causal, dtype, gen, timed):
    """Kernels 4, 5 and 6 against their plain versions on one shape; the
    backward kernels get the plain forward's out and lse, so each kernel is
    held alone.  Timed cases add kernel, plain and SDPA times (SDPA's
    backward alone, by autograd.grad over a retained graph, for 5 and 6):
    kernels and SDPA by graph replay, the kernels' event time beside."""
    import torch
    import torch.nn.functional as F

    from debiasing_multi_modal_tpu_torch.ops import flash_attention as fa

    q = torch.randn(b, sq, h, hd, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(b, skv, h, hd, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    dout = torch.randn(b, sq, h, hd, device="cuda", generator=gen).to(dtype)
    out, lse = fa.flash_attention_forward(q, k, v, causal)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal)
    delta = fa.flash_attention_delta(ref, dout)
    dq = fa.flash_attention_dq(q, k, v, dout, ref_lse, delta, causal)
    dk, dv = fa.flash_attention_dkv(q, k, v, dout, ref_lse, delta, causal)
    torch.cuda.synchronize()
    rdq, rdk, rdv = fa.flash_attention_backward_reference(q, k, v, ref, ref_lse, dout, causal)
    head = {"case": label, "shape": [b, sq, skv, h, hd], "causal": causal,
            "dtype": str(dtype)}
    rows, bad = {}, []
    for name, pairs in (("flash_attention", [("out", out, ref)]),
                        ("flash_attention_dq", [("dq", dq, rdq)]),
                        ("flash_attention_dkv", [("dk", dk, rdk), ("dv", dv, rdv)])):
        row = dict(head)
        for what, got, want in pairs:
            stats, ok = _close(got, want, dtype)
            row.update({f"{what}_{key}": val for key, val in stats.items()})
            if not ok:
                bad.append(f"{name} {what}")
        row["max_abs_err"] = max(row[f"{what}_max_abs_err"] for what, _, _ in pairs)
        rows[name] = row
    lse_err = (lse - ref_lse).abs().max().item()
    rows["flash_attention"]["lse_max_abs_err"] = lse_err
    if not lse_err <= 1e-4:  # f32 sums over <= 4096 keys in another order
        bad.append("flash_attention lse")
    del ref, rdq, rdk, rdv
    if timed:
        fast = dict(runs=5, calls=3, warmup=1) if sq * skv > 1e6 else {}
        heads = [x.transpose(1, 2) for x in (q, k, v)]
        sdpa_bwd_ms = _sdpa_backward_ms(heads, dout.transpose(1, 2), causal, fast)
        plain_bwd_ms = time_ms(lambda: fa.flash_attention_backward_reference(
            q, k, v, out, lse, dout, causal), **fast)
        bwd_call = ("SDPA backward alone (dq, dk, dv together, graph replay); plain "
                    "computes all three")
        calls = {
            "flash_attention": (
                lambda: fa.flash_attention_forward(q, k, v, causal),
                time_ms(lambda: fa.flash_attention_reference(q, k, v, causal), **fast),
                graph_ms(lambda: F.scaled_dot_product_attention(*heads, is_causal=causal),
                         **fast),
                "torch.nn.functional.scaled_dot_product_attention (graph replay)"),
            "flash_attention_dq": (
                lambda: fa.flash_attention_dq(q, k, v, dout, lse, delta, causal),
                plain_bwd_ms, sdpa_bwd_ms, bwd_call),
            "flash_attention_dkv": (
                lambda: fa.flash_attention_dkv(q, k, v, dout, lse, delta, causal),
                plain_bwd_ms, sdpa_bwd_ms, bwd_call),
        }
        bounds, peak_bounds = _flash_bounds(b, sq, skv, h, hd, causal, dtype, q.element_size())
        # the backward's row term, a plain reduction before kernels 5 and 6:
        # delta + 5 + 6 is what compares with SDPA's whole backward
        delta_ms = graph_ms(lambda: fa.flash_attention_delta(out, dout), **fast)
        for name, (fn, plain_ms, library_ms, call) in calls.items():
            # device time by graph replay; "events_ms" is the kernel timed as
            # PRs 3-5 timed it, with its wrapper's host time behind it
            rows[name].update({"ms": graph_ms(fn, **fast), "events_ms": time_ms(fn, **fast),
                               "plain_ms": plain_ms, "library_ms": library_ms,
                               "library_call": call})
            rows[name]["bound_ms"], rows[name]["bound_by"] = bounds[name]
            if dtype == torch.float32:
                rows[name]["bound_f32_fma_ms"] = peak_bounds[name]
        for name in ("flash_attention_dq", "flash_attention_dkv"):
            rows[name]["delta_ms"] = delta_ms
        rows["flash_attention_dkv"]["delta_dq_dkv_ms"] = (
            delta_ms + rows["flash_attention_dq"]["ms"] + rows["flash_attention_dkv"]["ms"])
        if dtype == torch.float32:
            rows["flash_attention_dkv"].update(_sdpa_backend(heads, dout.transpose(1, 2), causal))
    for name, row in rows.items():
        emit({"phase": "kernels", "kernel": name, **row})
    if bad:
        raise AssertionError(f"flash kernels disagree with their plain versions at {label}: "
                             f"{bad}")
    return rows


# the timed f32 cases of kernels 4-6: (label, B, Sq, Skv, H, hd, causal)
F32_FLASH_CASES = [("vitb32_train_image_f32", 128, 50, 50, 12, 64, False),
                   ("vitb32_train_text_f32", 128, 77, 77, 8, 64, True),
                   ("long_f32", 4, 2048, 2048, 16, 64, False)]


def _flash_cases(gen, f32_only=False):
    """Kernels 4-6 at the shapes listed in the module docstring; the first
    timed case (the ViT-B/32 image tower of the training step) is the one
    the summary line reports.  ``f32_only``: the timed f32 cases alone."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    results = {"flash_attention": [], "flash_attention_dq": [], "flash_attention_dkv": []}
    timed32 = [(*case, f32, True) for case in F32_FLASH_CASES]
    # (label, B, Sq, Skv, H, hd, causal, dtype, timed)
    for case in timed32 if f32_only else [
                 ("vitb32_train_image_bf16", 128, 50, 50, 12, 64, False, bf16, True),
                 ("vitb32_train_text_bf16", 128, 77, 77, 8, 64, True, bf16, True),
                 *timed32,
                 ("long_bf16", 4, 4096, 4096, 16, 64, False, bf16, True),
                 ("long_causal_bf16", 4, 4096, 4096, 16, 64, True, bf16, True),
                 ("ragged_cross_f32", 2, 1000, 77, 8, 64, False, f32, False),
                 ("ragged_cross_bf16", 2, 1000, 77, 8, 64, False, bf16, False),
                 ("hd32_causal_bf16", 8, 197, 197, 8, 32, True, bf16, False),
                 ("hd32_causal_f32", 8, 197, 197, 8, 32, True, f32, False),
                 ("hd128_f32", 4, 257, 257, 4, 128, False, f32, False),
                 ("hd128_causal_cross_bf16", 2, 300, 200, 4, 128, True, bf16, False),
                 ("causal_short_q_bf16", 2, 77, 300, 4, 64, True, bf16, False),
                 ("causal_short_q_f32", 2, 77, 300, 4, 64, True, f32, False)]:
        rows = _flash_case(*case[:8], gen, case[8])
        for name, row in rows.items():
            results[name].append(row)
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


def _counters():
    from debiasing_multi_modal_tpu_torch.ops import conv_gemm as cg
    from debiasing_multi_modal_tpu_torch.ops import flash_attention as fa
    from debiasing_multi_modal_tpu_torch.ops import fused_bottleneck as fb
    from debiasing_multi_modal_tpu_torch.ops import quant_gemm as qg
    from debiasing_multi_modal_tpu_torch.ops import short_attention as sa

    return {"short_attention": sa.short_attention,
            "short_attention_qtiled": sa.short_attention_qtiled,
            "short_attention_packed": sa.short_attention_packed,
            "int8_matmul": qg.int8_matmul,
            "flash_attention": fa.flash_attention,
            "flash_attention_dq": fa.flash_attention_dq,
            "flash_attention_dkv": fa.flash_attention_dkv,
            "fused_bottleneck_gemm": cg.fused_bottleneck_gemm,
            "fused_bottleneck": fb.fused_bottleneck}


def _zero_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _expect_counts(path, got, want):
    want = {name: want.get(name, 0) for name in _counters()}
    if got != want:
        raise AssertionError(f"{path}: expected launches {want}, got {got}")


def _rate(fn, items, reps):
    """Items per second of ``fn`` by the host clock around synchronized work."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return items * reps / (time.perf_counter() - t)


def _rel(a, b):
    import numpy as np

    return float(np.abs(a - b).max() / np.abs(b).max())


def _cos_min(a, b):
    import torch
    import torch.nn.functional as F

    a, b = (torch.as_tensor(x).float().cpu() for x in (a, b))
    return F.cosine_similarity(a, b, dim=-1).min().item()


def _stream(rng, shape, n_batches):
    import numpy as np

    metas = [{"filenames": np.array([f"{b}_{i}" for i in range(shape[0])]),
              "y": np.zeros(shape[0], np.int32), "place": np.zeros(shape[0], np.int32),
              "group": np.zeros(shape[0], np.int32), "split": np.zeros(shape[0], np.int32)}
             for b in range(n_batches)]
    return [(rng.integers(0, 256, shape, dtype=np.uint8), m) for m in metas]


def _batchnorm_check(gen):
    """``InferenceBatchNorm`` (one ``F.batch_norm`` pass) against the JAX
    module's formula ``x * inv + shift`` in f32, rounded once, at RN50's five
    BatchNorm widths (64 images, bf16, channels-last): within one bf16
    rounding at the output's scale (the card may reassociate the f32 terms)
    and equal on at least 99.9 % of the elements."""
    import torch

    from debiasing_multi_modal_tpu_torch.models.layers import InferenceBatchNorm

    rows = []
    for c, hw in ((64, 112), (256, 56), (512, 28), (1024, 14), (2048, 7)):
        bn = InferenceBatchNorm(c).cuda()
        with torch.no_grad():  # statistics as _realistic_bn_stats draws them
            bn.weight.copy_(torch.randn(c, device="cuda", generator=gen))
            bn.bias.copy_(torch.randn(c, device="cuda", generator=gen))
            bn.running_mean.copy_(torch.randn(c, device="cuda", generator=gen) * 0.2)
            bn.running_var.copy_(torch.rand(c, device="cuda", generator=gen) * 1.5 + 0.5)
        x = torch.randn(64, c, hw, hw, device="cuda", generator=gen).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            out = bn(x)
            inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            shift = bn.bias - bn.running_mean * inv
            ref = (x.float() * inv[:, None, None] + shift[:, None, None]).to(torch.bfloat16)
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        rows.append({"channels": c, "hw": hw, "max_abs_err": err, "scale": scale,
                     "equal_share": (out == ref).float().mean().item()})
        if not (err <= BF16_ULP * scale and rows[-1]["equal_share"] >= 0.999):
            raise AssertionError(f"InferenceBatchNorm disagrees with the JAX formula: {rows[-1]}")
    return rows


def phase_slice():
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.extract.runner import ExtractionRunner
    from debiasing_multi_modal_tpu_torch.models import create_clip

    def seeded():
        return torch.Generator().manual_seed(SEED)

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    model = create_clip("RN50", dtype=torch.bfloat16, device="cuda", generator=seeded())
    setup_s = time.perf_counter() - t0
    tokens = torch.from_numpy(_tokens(256, rng)).cuda()
    images = rng.integers(0, 256, (256, 256, 256, 3), dtype=np.uint8)

    # ---- the main path, with every launch count at 0 just before it
    _zero_counts()
    with torch.inference_mode():
        text = model.encode_text(tokens)
    runner = ExtractionRunner(model, text[:2].float().cpu().numpy())
    emb, preds = runner.encode_batch(images)
    torch.cuda.synchronize()
    launches = _read_counts()
    # ----
    _expect_counts("RN50", launches, {"short_attention": model.config.transformer_layers})
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
    text_cos = _cos_min(text32, text_plain)
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

    checks = {"image_f32_cuda_vs_cpu_rel": _rel(emb_cuda, emb_cpu),
              "text_f32_cuda_vs_cpu_rel": _rel(txt_cuda, txt_cpu),
              "image_bf16_vs_f32_min_cosine": _cos_min(emb_bf16, emb_cuda),
              "text_kernel_vs_plain_bf16_min_cosine": text_cos,
              "batchnorm_vs_jax_formula": _batchnorm_check(
                  torch.Generator(device="cuda").manual_seed(SEED))}
    if not (checks["image_f32_cuda_vs_cpu_rel"] <= 1e-3
            and checks["text_f32_cuda_vs_cpu_rel"] <= 1e-3
            and checks["image_bf16_vs_f32_min_cosine"] >= 0.99):
        raise AssertionError(f"tower outputs disagree: {checks}")
    del cuda32, cpu32

    def text_encode():
        with torch.inference_mode():
            model.encode_text(tokens)

    uploaded = runner.upload_batch(images)
    # one step on an uploaded batch must not make the host wait for the card
    with no_host_sync():
        runner.encode_batch_async(uploaded)
    torch.cuda.synchronize()
    checks["encode_batch_async_host_sync_free"] = True
    stream = _stream(rng, images.shape, 8)
    t = time.perf_counter()
    table = runner.run(iter(stream))
    run_imgs_s = len(table) / (time.perf_counter() - t)
    prompts_per_s = _rate(text_encode, 256, 10)
    perf = {
        "prompts_per_s": prompts_per_s,
        "imgs_per_s_device": _rate(lambda: runner.encode_batch_async(uploaded), 256, 10),
        "imgs_per_s_encode_batch": _rate(lambda: runner.encode_batch(images), 256, 5),
        "imgs_per_s_run_8_batches": run_imgs_s,
        "text_encode_ms": 256 / prompts_per_s * 1e3,
        "host_load_avg_1_5_15_min": os.getloadavg(),
    }
    emit({"phase": "slice", "model": "RN50", "dtype": "bfloat16", "batch": 256,
          "image_hw": [256, 256], "launches": launches, "checks": checks,
          "perf": perf, "model_setup_s": setup_s})
    return {"rn50": launches}, perf


def _realistic_bn_stats(model, rng):
    """Overwrite every visual BatchNorm's statistics from ``rng``: mean ~
    N(0, 0.2^2), var ~ U(0.5, 2), as the JAX package's tests/test_fold.py
    (seeded weights have identity BatchNorms, which would make folding a
    no-op)."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.models.layers import InferenceBatchNorm

    for mod in model.visual.modules():
        if isinstance(mod, InferenceBatchNorm):
            n = mod.running_mean.numel()
            mod.running_mean.copy_(torch.from_numpy(
                (rng.standard_normal(n) * 0.2).astype(np.float32)))
            mod.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)))


def _fold_rn50(rng):
    """Seeded RN50 in bf16 on the card with non-trivial BatchNorm statistics
    from ``rng``, and its folded state dict: ``(unfused, folded(dtype,
    device), fold seconds)``."""
    import torch

    from debiasing_multi_modal_tpu_torch.models import create_clip
    from debiasing_multi_modal_tpu_torch.weights.convert import clip_from_state_dict
    from debiasing_multi_modal_tpu_torch.weights.fold import fold_resnet_bn

    unfused = create_clip("RN50", dtype=torch.bfloat16, device="cuda",
                          generator=torch.Generator().manual_seed(SEED))
    _realistic_bn_stats(unfused, rng)
    t0 = time.perf_counter()
    folded_sd = fold_resnet_bn({k: v.cpu().numpy() for k, v in unfused.state_dict().items()})
    fold_s = time.perf_counter() - t0

    def folded(dtype, device):
        return clip_from_state_dict(folded_sd, name="RN50", dtype=dtype, device=device,
                                    fuse_bn=True)

    return unfused, folded, fold_s


def phase_fuse_bn(slice_perf):
    """RN50 at full width, bf16, with folded BatchNorms (see the module
    docstring); returns the launch counts and the folded model."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.extract.runner import ExtractionRunner

    rng = np.random.default_rng(SEED + 3)
    unfused, folded, fold_s = _fold_rn50(rng)
    model = folded(torch.bfloat16, "cuda")
    tokens = torch.from_numpy(_tokens(256, rng)).cuda()
    images = rng.integers(0, 256, (256, 256, 256, 3), dtype=np.uint8)

    # ---- the main path, with every launch count at 0 just before it
    _zero_counts()
    with torch.inference_mode():
        text = model.encode_text(tokens)
    zs = text[:2].float().cpu().numpy()
    runner = ExtractionRunner(model, zs)
    emb, preds = runner.encode_batch(images)
    torch.cuda.synchronize()
    launches = _read_counts()
    # ----
    _expect_counts("RN50 fuse_bn", launches, {"short_attention": model.config.transformer_layers})
    text32 = text.float()
    if not (torch.isfinite(text32).all() and text32.shape == (256, 1024)
            and np.isfinite(emb).all() and emb.shape == (256, 1024)):
        raise AssertionError("fuse_bn: embeddings are not finite [256, 1024]")
    if not (preds.shape == (256,) and preds.min() >= 0 and preds.max() < 2):
        raise AssertionError("fuse_bn: zero-shot predictions out of range")

    u_runner = ExtractionRunner(unfused, zs)
    u_emb, u_preds = u_runner.encode_batch(images)
    small = rng.integers(0, 256, (4, 224, 224, 3), dtype=np.uint8)
    emb_cuda, _ = ExtractionRunner(folded(torch.float32, "cuda"), zs).encode_batch(small)
    emb_cpu, _ = ExtractionRunner(folded(torch.float32, "cpu"), zs).encode_batch(small)
    checks = {"image_vs_unfused_bf16_min_cosine": _cos_min(emb, u_emb),
              "preds_equal_unfused_share": float(np.mean(preds == u_preds)),
              "image_f32_cuda_vs_cpu_rel": _rel(emb_cuda, emb_cpu)}

    uploaded = runner.upload_batch(images)
    stream = _stream(rng, images.shape, 8)
    t = time.perf_counter()
    table = runner.run(iter(stream))
    run_imgs_s = len(table) / (time.perf_counter() - t)
    perf = {
        "imgs_per_s_device": _rate(lambda: runner.encode_batch_async(uploaded), 256, 10),
        "imgs_per_s_encode_batch": _rate(lambda: runner.encode_batch(images), 256, 5),
        "imgs_per_s_run_8_batches": run_imgs_s,
        "unfused_imgs_per_s_device": _rate(lambda: u_runner.encode_batch_async(uploaded),
                                           256, 10),
        "host_load_avg_1_5_15_min": os.getloadavg(),
    }
    emit({"phase": "fuse_bn", "model": "RN50", "dtype": "bfloat16", "batch": 256,
          "image_hw": [256, 256], "launches": launches, "checks": checks, "perf": perf,
          "unfused_slice_perf": {k: slice_perf[k] for k in (
              "imgs_per_s_device", "imgs_per_s_encode_batch", "imgs_per_s_run_8_batches")},
          "fold_s": fold_s})
    if not (checks["image_vs_unfused_bf16_min_cosine"] >= 0.999
            and checks["preds_equal_unfused_share"] >= 0.99
            and checks["image_f32_cuda_vs_cpu_rel"] <= 1e-3):
        raise AssertionError(f"RN50 fuse_bn disagrees: {checks}")
    return {"rn50_fuse_bn": launches}, model


def _bottleneck_bound_ms(b, h, cin, m, cout, ds, itemsize):
    """Each input read once (x, weights of x's dtype, f32 biases), the output
    written once; 2 flops per multiply-add of the four (five) products at
    the bf16 (f32) peak."""
    import torch

    macs_per_px = cin * m + 9 * m * m + m * cout + (cin * cout if ds else 0)
    weight_bytes = macs_per_px * itemsize + 4 * (2 * m + cout + (cout if ds else 0))
    nbytes = b * h * h * (cin + cout) * itemsize + weight_bytes
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    flops_ms = 2 * b * h * h * macs_per_px / PEAK_FLOPS[str(dtype)] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


def _block_close(out, ref):
    import torch
    import torch.nn.functional as F

    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    cos = F.cosine_similarity(out.float().flatten(), ref.float().flatten(), dim=0).item()
    return err, scale, cos


def phase_rn50_blocks(model):
    """Kernels 8 and 9 at every stride-1 block of the folded RN50 (see the
    module docstring); returns the launch counts and the per-kernel cases."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.ops import conv_gemm as cg
    from debiasing_multi_modal_tpu_torch.ops import fused_bottleneck as fb
    from debiasing_multi_modal_tpu_torch.ops.preprocess import preprocess_uint8

    rng = np.random.default_rng(SEED + 4)
    u8 = torch.from_numpy(rng.integers(0, 256, (256, 256, 256, 3), dtype=np.uint8)).cuda()
    blocks, handles = {}, []
    for stage in range(1, 5):
        for i, block in enumerate(getattr(model.visual, f"layer{stage}")):
            if block.stride != 1:
                continue
            name = f"l{stage}b{i}" + ("_ds" if block.downsample is not None else "")
            blocks[name] = {"block": block}
            handles.append(block.register_forward_pre_hook(
                lambda m, inp, name=name: blocks[name].__setitem__("x", inp[0])))
            handles.append(block.register_forward_hook(
                lambda m, inp, out, name=name: blocks[name].__setitem__("model", out)))
    with torch.inference_mode():
        model.encode_image(preprocess_uint8(u8, 224, dtype=torch.bfloat16))
    for h in handles:
        h.remove()
    del u8
    if len(blocks) != 13:
        raise AssertionError(f"expected 13 stride-1 blocks, found {sorted(blocks)}")
    for entry in blocks.values():
        entry["x_nhwc"] = entry["x"].permute(0, 2, 3, 1)
        entry["weights"] = cg.block_weights(entry["block"])
        b, h, _, cin = entry["x_nhwc"].shape
        entry["strip"] = cg.pick_strip_rows(h, h, entry["weights"][0].shape[1], 2)

    # ---- the main path, with every launch count at 0 just before it
    _zero_counts()
    with torch.inference_mode():
        for entry in blocks.values():
            x, w = entry["x_nhwc"], entry["weights"]
            entry["k8"] = cg.fused_bottleneck_gemm(x, *w, strip_rows=entry["strip"])
            if w[6] is None:
                entry["k9"] = fb.fused_bottleneck(x, *w[:6])
    torch.cuda.synchronize()
    launches = _read_counts()
    # ----
    _expect_counts("rn50_blocks", launches, {"fused_bottleneck_gemm": 13, "fused_bottleneck": 12})

    cases = {"fused_bottleneck_gemm": [], "fused_bottleneck": []}
    bad = []
    timed = ("l1b1", "l1b0_ds", "l2b1", "l3b1", "l4b1")  # l1b1 first: the summary's shape
    for name in sorted(blocks, key=lambda n: (timed.index(n) if n in timed else len(timed), n)):
        entry = blocks[name]
        x, w = entry["x_nhwc"], entry["weights"]
        b, h, _, cin = x.shape
        m, cout, ds = w[0].shape[1], w[4].shape[1], w[6] is not None
        with torch.inference_mode():
            plain = cg.xla_bottleneck(x, *w)
        model_out = entry["model"].permute(0, 2, 3, 1)
        for kname, key in (("fused_bottleneck_gemm", "k8"), ("fused_bottleneck", "k9")):
            if key not in entry:
                continue
            err, scale, cos = _block_close(entry[key], plain)
            _, _, cos_model = _block_close(entry[key], model_out)
            row = {"case": name, "shape": [b, h, h, cin, m, cout], "downsample": ds,
                   "dtype": "torch.bfloat16", "strip_rows": entry["strip"],
                   "input_nhwc_contiguous": x.is_contiguous(), "max_abs_err": err,
                   "scale": scale, "cosine": cos, "cosine_vs_model_block": cos_model}
            if not (err <= 2e-2 * scale and cos >= 0.9999 and cos_model >= 0.999):
                bad.append(f"{kname} {name}")
            if name in timed:
                fast = dict(runs=10, calls=5, warmup=2)
                with torch.inference_mode():
                    if key == "k8":
                        row["ms"] = time_ms(lambda: cg.fused_bottleneck_gemm(
                            x, *w, strip_rows=entry["strip"]), **fast)
                    else:
                        row["ms"] = time_ms(lambda: fb.fused_bottleneck(x, *w[:6]), **fast)
                    row["plain_ms"] = time_ms(lambda: cg.xla_bottleneck(x, *w), **fast)
                    row["model_block_ms"] = time_ms(
                        lambda: entry["block"](entry["x"]), **fast)
                row["library_ms"] = None
                row["library_call"] = "none: no single call computes the block"
                row["bound_ms"], row["bound_by"] = _bottleneck_bound_ms(
                    b, h, cin, m, cout, ds, x.element_size())
            emit({"phase": "rn50_blocks", "kernel": kname, **row})
            cases[kname].append(row)
        del plain, model_out

    # f32 on one block (l2b1 at 8 images): both kernels against the plain
    # version and the model's block run in f32 (on no main path; timed for
    # the record, TF32 off as the f32 convolutions always run)
    entry = blocks["l2b1"]
    x = entry["x_nhwc"][:8].float()
    w = [t.float() for t in entry["weights"][:6]]
    strip = cg.pick_strip_rows(x.shape[1], x.shape[2], w[0].shape[1], 4)
    block32 = copy.deepcopy(entry["block"])
    block32.dtype = torch.float32
    x_nchw = entry["x"][:8].float()
    fast = dict(runs=10, calls=5, warmup=2)
    with torch.inference_mode():
        plain = cg.xla_bottleneck(x, *w)
        model32 = block32(x_nchw).permute(0, 2, 3, 1)
        timings = {"plain_ms": time_ms(lambda: cg.xla_bottleneck(x, *w), **fast),
                   "model_block_ms": time_ms(lambda: block32(x_nchw), **fast)}
        for kname, run in (("fused_bottleneck_gemm",
                            lambda: cg.fused_bottleneck_gemm(x, *w, strip_rows=strip)),
                           ("fused_bottleneck", lambda: fb.fused_bottleneck(x, *w))):
            out = run()
            err, scale, cos = _block_close(out, plain)
            _, _, cos_model = _block_close(out, model32)
            b, h, _, cin = x.shape
            row = {"case": "l2b1_f32", "shape": list(x.shape) + [w[0].shape[1], w[4].shape[1]],
                   "downsample": False, "dtype": "torch.float32", "strip_rows": strip,
                   "max_abs_err": err, "scale": scale, "cosine": cos,
                   "cosine_vs_model_block": cos_model, "ms": time_ms(run, **fast),
                   **timings, "library_ms": None,
                   "library_call": "none: no single call computes the block"}
            row["bound_ms"], row["bound_by"] = _bottleneck_bound_ms(
                b, h, cin, w[0].shape[1], w[4].shape[1], False, 4)
            if not (err <= 1e-4 * scale and cos_model >= 0.999):
                bad.append(f"{kname} l2b1_f32")
            emit({"phase": "rn50_blocks", "kernel": kname, **row})
            cases[kname].append(row)
    del block32
    if bad:
        raise AssertionError(f"bottleneck kernels disagree: {bad}")
    return {"rn50_blocks": launches}, cases


def phase_vit():
    """ViT-B/32 at full width and depth, bf16: unfused, fuse_qkv, int8_pallas."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.extract.runner import ExtractionRunner
    from debiasing_multi_modal_tpu_torch.models import create_clip

    def build(**kw):
        return create_clip("ViT-B/32", device="cuda", generator=torch.Generator().manual_seed(SEED),
                           **{"dtype": torch.bfloat16, **kw})

    rng = np.random.default_rng(SEED + 1)
    t0 = time.perf_counter()
    model = build()
    setup_s = time.perf_counter() - t0
    layers = model.config.vision_layers + model.config.transformer_layers
    tokens = torch.from_numpy(_tokens(256, rng)).cuda()
    images = rng.integers(0, 256, (256, 256, 256, 3), dtype=np.uint8)
    zs = None

    def drive(m, name, want):
        """The main path (text encode, then one encode_batch) with every
        launch count at 0 just before it and read just after."""
        nonlocal zs
        _zero_counts()
        with torch.inference_mode():
            text = m.encode_text(tokens)
        if zs is None:
            zs = text[:2].float().cpu().numpy()
        runner = ExtractionRunner(m, zs)
        emb, preds = runner.encode_batch(images)
        torch.cuda.synchronize()
        counts = _read_counts()
        _expect_counts(name, counts, want)
        text32 = text.float().cpu().numpy()
        if not (np.isfinite(emb).all() and emb.shape == (256, 512)
                and np.isfinite(text32).all() and text32.shape == (256, 512)):
            raise AssertionError(f"{name}: embeddings are not finite [256, 512]")
        if not (preds.shape == (256,) and preds.min() >= 0 and preds.max() < 2):
            raise AssertionError(f"{name}: zero-shot predictions out of range")
        return runner, text32, emb, counts

    launches, checks, perf = {}, {}, {}
    runner, text, emb, launches["vit_b32"] = drive(
        model, "ViT-B/32", {"short_attention": layers})
    fused = build(fuse_qkv=True)
    f_runner, f_text, f_emb, launches["vit_b32_fuse_qkv"] = drive(
        fused, "ViT-B/32 fuse_qkv", {"short_attention_packed": layers})
    q8 = build(quant="int8_pallas")
    q_runner, q_text, q_emb, launches["vit_b32_int8_pallas"] = drive(
        q8, "ViT-B/32 int8_pallas",
        {"short_attention": layers, "int8_matmul": 6 * model.config.vision_layers})

    # the same weights under the plain attention formulation, both towers
    plain = build(attn_impl="xla")
    with torch.inference_mode():
        text_plain = plain.encode_text(tokens).float().cpu().numpy()
    emb_plain, _ = ExtractionRunner(plain, zs).encode_batch(images)
    del plain
    # the same integer products with torch._int_mm in place of kernel 7; the
    # epilogues differ only in where the bias add rounds (a few f32 ulps)
    int8_xla = ExtractionRunner(build(quant="int8"), zs)
    i_emb, _ = int8_xla.encode_batch(images)
    checks["text_kernel_vs_plain_bf16_min_cosine"] = _cos_min(text, text_plain)
    checks["image_kernel_vs_plain_bf16_min_cosine"] = _cos_min(emb, emb_plain)
    checks["fuse_qkv_vs_unfused_image_min_cosine"] = _cos_min(f_emb, emb)
    checks["fuse_qkv_vs_unfused_text_min_cosine"] = _cos_min(f_text, text)
    checks["int8_pallas_vs_bf16_image_min_cosine"] = _cos_min(q_emb, emb)
    checks["int8_pallas_vs_int8_int_mm_image_min_cosine"] = _cos_min(q_emb, i_emb)
    checks["int8_pallas_text_equals_bf16_text"] = bool(np.array_equal(q_text, text))

    # f32 towers on the card (kernel attention, TF32 off) against the CPU
    small = rng.integers(0, 256, (4, 224, 224, 3), dtype=np.uint8)
    emb_cuda, _ = ExtractionRunner(build(dtype=torch.float32), zs).encode_batch(small)
    cpu32 = create_clip("ViT-B/32", device="cpu", generator=torch.Generator().manual_seed(SEED))
    emb_cpu, _ = ExtractionRunner(cpu32, zs).encode_batch(small)
    del cpu32
    checks["image_f32_cuda_vs_cpu_rel"] = _rel(emb_cuda, emb_cpu)
    emit({"phase": "vit", "checks": checks})
    if not (checks["text_kernel_vs_plain_bf16_min_cosine"] >= 0.999
            and checks["image_kernel_vs_plain_bf16_min_cosine"] >= 0.999
            and checks["fuse_qkv_vs_unfused_image_min_cosine"] >= 0.999
            and checks["fuse_qkv_vs_unfused_text_min_cosine"] >= 0.999
            and checks["int8_pallas_vs_bf16_image_min_cosine"] >= 0.99
            and checks["int8_pallas_vs_int8_int_mm_image_min_cosine"] >= 0.999
            and checks["int8_pallas_text_equals_bf16_text"]
            and checks["image_f32_cuda_vs_cpu_rel"] <= 1e-3):
        raise AssertionError(f"ViT-B/32 outputs disagree: {checks}")

    def text_encode():
        with torch.inference_mode():
            model.encode_text(tokens)

    uploaded = runner.upload_batch(images)
    with no_host_sync():
        runner.encode_batch_async(uploaded)
    torch.cuda.synchronize()
    stream = _stream(rng, images.shape, 8)
    t = time.perf_counter()
    table = runner.run(iter(stream))
    run_imgs_s = len(table) / (time.perf_counter() - t)
    prompts_per_s = _rate(text_encode, 256, 10)
    perf = {
        "host_load_avg_1_5_15_min": os.getloadavg(),
        "prompts_per_s": prompts_per_s,
        "imgs_per_s_device": _rate(lambda: runner.encode_batch_async(uploaded), 256, 10),
        "imgs_per_s_encode_batch": _rate(lambda: runner.encode_batch(images), 256, 5),
        "imgs_per_s_run_8_batches": run_imgs_s,
        "text_encode_ms": 256 / prompts_per_s * 1e3,
        "imgs_per_s_device_fuse_qkv": _rate(lambda: f_runner.encode_batch_async(uploaded), 256, 10),
        "imgs_per_s_device_int8_pallas": _rate(lambda: q_runner.encode_batch_async(uploaded), 256, 10),
        "imgs_per_s_device_int8_int_mm": _rate(lambda: int8_xla.encode_batch_async(uploaded), 256, 10),
    }
    emit({"phase": "vit", "model": "ViT-B/32", "dtype": "bfloat16", "batch": 256,
          "image_hw": [256, 256], "launches": launches, "perf": perf,
          "encode_batch_async_host_sync_free": True, "model_setup_s": setup_s})
    return launches


def phase_qtiled():
    """ViT-L/14@336px at its zoo default f32: every image attention is
    kernel 2 (24 launches), every text attention f32 kernel 1 (12).  The
    launch counts are set to 0, then four 336x336 images and 256 synthetic
    prompts are encoded, then the counts are read.  Both towers are held to
    the same weights under the plain attention formulation within 1e-4 of
    the output's scale: both sum in f32 (TF32 off), in other orders, through
    24 or 12 layers; the measured gap is ~1e-6."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.models import create_clip

    def build(**kw):
        return create_clip("ViT-L/14@336px", device="cuda",
                           generator=torch.Generator().manual_seed(SEED), **kw)

    model = build()
    x = torch.randn(4, 336, 336, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(SEED))
    tokens = torch.from_numpy(_tokens(256, np.random.default_rng(SEED + 5))).cuda()
    # ---- the main path, with every launch count at 0 just before it
    _zero_counts()
    with torch.inference_mode():
        emb = model.encode_image(x)
        text = model.encode_text(tokens)
    torch.cuda.synchronize()
    launches = _read_counts()
    # ----
    _expect_counts("ViT-L/14@336px", launches,
                   {"short_attention_qtiled": model.config.vision_layers,
                    "short_attention": model.config.transformer_layers})

    def text_encode():
        with torch.inference_mode():
            model.encode_text(tokens)

    image_ms = time_ms(lambda: model.encode_image(x), runs=5, calls=3, warmup=1)
    prompts_per_s = _rate(text_encode, 256, 5)
    del model
    plain = build(attn_impl="xla")
    with torch.inference_mode():
        ref = plain.encode_image(x)
        text_ref = plain.encode_text(tokens)
    emb, ref = emb.cpu().numpy(), ref.cpu().numpy()
    text, text_ref = text.cpu().numpy(), text_ref.cpu().numpy()
    rel, text_rel = _rel(emb, ref), _rel(text, text_ref)
    row = {"phase": "qtiled", "model": "ViT-L/14@336px", "dtype": "float32",
           "images": [4, 336, 336], "prompts": 256, "launches": launches,
           "kernel_vs_plain_attention_rel": rel, "text_kernel_vs_plain_attention_rel": text_rel,
           "tolerance": 1e-4, "encode_image_ms": image_ms, "prompts_per_s": prompts_per_s,
           "text_encode_ms": 256 / prompts_per_s * 1e3}
    emit(row)
    if not (np.isfinite(emb).all() and emb.shape == (4, 768) and rel <= 1e-4
            and np.isfinite(text).all() and text.shape == (256, 768) and text_rel <= 1e-4):
        raise AssertionError(f"ViT-L/14@336px through kernels 2 and 1 disagrees: {row}")
    return {"vit_l14_336": launches}


def _grads(model):
    return {name: p.grad.detach().clone() for name, p in model.named_parameters()}


def _grad_cosines(a, b):
    """Per-parameter cosine of two gradient dicts, and over all parameters
    flattened."""
    import torch
    import torch.nn.functional as F

    per = {n: F.cosine_similarity(a[n].flatten().double(), b[n].flatten().double(),
                                  dim=0).item() for n in a}
    flat = F.cosine_similarity(torch.cat([a[n].flatten().double() for n in a]),
                               torch.cat([b[n].flatten().double() for n in a]), dim=0).item()
    return per, flat


def phase_train(f32_only=False):
    """A gradient step through the full ViT-B/32 CLIP on the card (see the
    module docstring).  ``f32_only``: the f32 128-pair step alone."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from debiasing_multi_modal_tpu_torch.models import create_clip
    from debiasing_multi_modal_tpu_torch.ops.preprocess import preprocess_uint8

    n = 128
    rng = np.random.default_rng(SEED + 2)
    images = torch.from_numpy(rng.integers(0, 256, (n, 256, 256, 3), dtype=np.uint8)).cuda()
    tokens = torch.from_numpy(_tokens(n, rng)).cuda()
    labels = torch.arange(n, device="cuda")

    def build(dtype=torch.bfloat16, device="cuda", **kw):
        model = create_clip("ViT-B/32", dtype=dtype, device=device,
                            generator=torch.Generator().manual_seed(SEED), **kw)
        return model.requires_grad_(True)

    def loss_of(model, imgs, toks, lab):
        logits_per_image, logits_per_text = model(imgs, toks)
        return (F.cross_entropy(logits_per_image, lab)
                + F.cross_entropy(logits_per_text, lab)) / 2

    def grad_step(model, opt, u8=images, toks=tokens, lab=labels):
        """The loss and its gradients, without the update."""
        opt.zero_grad(set_to_none=True)
        imgs = preprocess_uint8(u8, model.config.image_resolution, dtype=model.config.dtype)
        loss = loss_of(model, imgs, toks, lab)
        loss.backward()
        return loss

    def step(model, opt):
        loss = grad_step(model, opt)
        opt.step()
        return loss

    def first_step(name, want, **kw):
        """One step with every launch count at 0 just before it; the loss,
        the launch counts and the gradients (before the update)."""
        model = build(**kw)
        opt = torch.optim.SGD(model.parameters(), lr=1e-3)
        _zero_counts()
        loss = grad_step(model, opt)
        torch.cuda.synchronize()
        counts = _read_counts()
        _expect_counts(name, counts, want)
        grads = _grads(model)
        opt.step()
        return model, opt, loss.item(), counts, grads

    def step_ms(model, opt, reps=5):
        """ms per step by the host clock around ``reps`` synchronized steps."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            step(model, opt)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    layers = 24  # 12 image + 12 text blocks
    flash = {"flash_attention": layers, "flash_attention_dq": layers,
             "flash_attention_dkv": layers}

    def f32_step():
        """The step at the JAX package's default dtype, f32, on all 128
        pairs (kernels 4, 5 and 6 as split-TF32): launch
        counts, finite loss and gradients, no host wait, ms per step."""
        model, opt, loss, counts, grads = first_step(
            "ViT-B/32 train f32", flash, dtype=torch.float32, attn_impl="pallas")
        finite = bool(np.isfinite(loss)) and all(
            torch.isfinite(g).all().item() for g in grads.values())
        del grads
        with no_host_sync():
            step(model, opt)
        torch.cuda.synchronize()
        ms = step_ms(model, opt, reps=3)
        del model, opt
        return counts, {"train_step_ms_f32": ms, "train_pairs_per_s_f32": n / ms * 1e3}, finite

    if f32_only:
        counts, perf, finite = f32_step()
        emit({"phase": "train", "model": "ViT-B/32", "dtype": "float32", "pairs": n,
              "launches": {"vit_b32_train_f32": counts}, "perf": perf,
              "checks": {"f32_step_finite": finite, "step_host_sync_free": True}})
        if not finite:
            raise AssertionError("ViT-B/32 f32 training step: loss or gradients not finite")
        return {"vit_b32_train_f32": counts}

    launches, checks = {}, {}
    model, opt, loss1, launches["vit_b32_train"], g_pallas = first_step(
        "ViT-B/32 train", flash, attn_impl="pallas")
    losses = [loss1] + [step(model, opt).item() for _ in range(2)]
    finite = all(np.isfinite(losses)) and all(
        torch.isfinite(g).all().item() for g in g_pallas.values())
    finite = finite and all(torch.isfinite(p.grad).all().item()
                            for p in model.parameters())

    # one whole step (preprocess, forward, backward, SGD) must not make the
    # host wait for the card
    with no_host_sync():
        step(model, opt)
    torch.cuda.synchronize()
    checks["step_host_sync_free"] = True
    perf = {"train_step_ms": step_ms(model, opt)}
    perf["train_pairs_per_s"] = n / perf["train_step_ms"] * 1e3
    perf["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, opt

    model, opt, _, launches["vit_b32_train_remat"], g_remat = first_step(
        "ViT-B/32 train remat", {**flash, "flash_attention": 2 * layers},
        attn_impl="pallas", remat=True)
    perf["train_step_ms_remat"] = step_ms(model, opt, reps=3)
    del model, opt
    remat_gap = {n: (g_remat[n] - g_pallas[n]).abs().max().item() for n in g_pallas}
    checks["remat_bit_equal_tensors"] = sum(torch.equal(g_remat[n], g_pallas[n])
                                            for n in g_pallas)
    checks["remat_max_abs_gap"] = max(remat_gap.values())
    checks["remat_differing"] = sorted(n for n, gap in remat_gap.items() if gap > 0)
    del g_remat
    model, opt, _, launches["vit_b32_train_xla"], g_xla = first_step(
        "ViT-B/32 train xla", {}, attn_impl="xla")
    perf["train_step_ms_xla"] = step_ms(model, opt, reps=3)
    del model, opt
    model, opt, _, launches["vit_b32_train_auto"], g_auto = first_step(
        "ViT-B/32 train auto", {"short_attention": layers}, attn_impl="auto")
    perf["train_step_ms_auto"] = step_ms(model, opt, reps=3)
    del model, opt
    per, flat = _grad_cosines(g_pallas, g_xla)
    checks["pallas_vs_xla_min_param_cosine"] = min(per.values())
    checks["pallas_vs_xla_min_param"] = min(per, key=per.get)
    checks["pallas_vs_xla_cosine"] = flat
    per_auto, flat_auto = _grad_cosines(g_auto, g_xla)
    checks["auto_vs_xla_cosine"] = flat_auto
    checks["auto_vs_xla_min_param_cosine"] = min(per_auto.values())
    del g_xla, g_auto
    launches["vit_b32_train_f32"], perf_f32, checks["f32_step_finite"] = f32_step()
    perf.update(perf_f32)

    # f32 on 4 pairs: the card (kernels 4-6, TF32 off) against the CPU
    few = dict(u8=images[:4], toks=tokens[:4], lab=labels[:4])
    grads32 = {}
    for device in ("cuda", "cpu"):
        m32 = build(dtype=torch.float32, device=device, attn_impl="pallas")
        grad_step(m32, torch.optim.SGD(m32.parameters(), lr=1e-3),
                  **{k: v.to(device) for k, v in few.items()})
        grads32[device] = {k: v.cpu() for k, v in _grads(m32).items()}
        del m32
    rel = {n: ((grads32["cuda"][n] - grads32["cpu"][n]).abs().max()
               / grads32["cpu"][n].abs().max()).item() for n in grads32["cpu"]}
    checks["f32_cuda_vs_cpu_max_rel"] = max(rel.values())
    checks["f32_cuda_vs_cpu_worst_param"] = max(rel, key=rel.get)

    emit({"phase": "train", "model": "ViT-B/32", "dtype": "bfloat16 compute, f32 params",
          "pairs": n, "losses": losses, "launches": launches, "checks": checks,
          "perf": perf})
    if not (finite and checks["f32_step_finite"]
            and checks["pallas_vs_xla_min_param_cosine"] >= 0.99
            and checks["pallas_vs_xla_cosine"] >= 0.999
            and checks["auto_vs_xla_cosine"] >= 0.999
            and checks["remat_max_abs_gap"] == 0.0
            and checks["f32_cuda_vs_cpu_max_rel"] <= 1e-3):
        raise AssertionError(f"ViT-B/32 training step disagrees: finite={finite} {checks}")
    return launches


# Stage B (the second half of the main path): the flagship configuration of
# scripts/run_final_main.sh on an RN50-width synthetic cache with the
# Waterbirds split sizes, epochs cut to 6 across the phase boundary.
STAGE_B_SPEC = dict(dim=1024, n_train=4795, n_val=1199, n_test=5794)
STAGE_B_FLAGS = dict(tl_method="adapter_reg_seq_alter", add_adapter=True, warm_reg=True,
                     batch_size=1024, batch_size_reg=256, learning_rate=1.0,
                     learning_rate_reg=1.0, lr_decay_rate=0.1, lr_decay_epochs=(90, 95),
                     epochs=6, epochs_feature_learning=3, input_dim=1024, random_seed=42)
CELEBA_TRAIN_ROWS, CELEBA_VAL_ROWS = 162770, 19867
# card against CPU, final checkpoint: six epochs at lr 1.0 grow f32 rounding
# (a 1-ulp change of the initial weights leaves ~7e-5 of scale on the CPU),
# while the old_cls branch's BatchNorm held still in phase 2 leaves ~1.1
FINAL_STATE_LIMIT = 1e-2


def _stage_b_bundle(data, device):
    import numpy as np

    from debiasing_multi_modal_tpu_torch.train.loop import bundle_from_embedding_table

    meta, table, text_class, text_group, text_spurious = data
    splits = {name: meta.take(np.where(meta.split == sid)[0])
              for name, sid in (("train", 0), ("val", 1), ("test", 2))}
    return bundle_from_embedding_table(table, splits, text_class, text_spurious, text_group,
                                       device=device)


def _stage_b_init(cfg):
    """The initial state both runs start from: the phase-1 adapter and the
    stage switch's new adapter, drawn from one seeded generator in the
    reference's state-dict layout (the draws train_all_epochs makes itself)."""
    import torch

    from debiasing_multi_modal_tpu_torch.train.loop import (
        make_classifier,
        make_multiple_classifier,
    )

    gen = torch.Generator().manual_seed(cfg.random_seed)
    init_sd = make_classifier(cfg, gen).state_dict()
    new = make_multiple_classifier(cfg, gen).new_adapter.state_dict()
    return {"init_sd": init_sd, "ma_new_sd": {f"new_adapter.{k}": v for k, v in new.items()}}


def _payload_gaps(ours, ref, path=""):
    """``{key path: max |ours - ref| / scale}`` over the floating tensors of
    two checkpoint payloads (nested dicts of tensors), the scale being
    ``max |ref|``.  fc1's bias (``layers.0.bias``) feeds a BatchNorm, so its
    gradient is zero but for rounding: it and its trace are held to the
    scale of fc1's weight, as the CPU parity tests hold them.  A tensor
    whose scale is 0 (a frozen branch's trace) keeps the absolute gap."""
    assert set(ours) == set(ref), (path, sorted(ours), sorted(ref))
    gaps = {}
    for k, r in ref.items():
        if isinstance(r, dict):
            gaps.update(_payload_gaps(ours[k], r, f"{path}/{k}"))
        elif r.is_floating_point():
            scale = ref[k.replace("layers.0.bias", "layers.0.weight")].abs().max().item()
            gaps[f"{path}/{k}"] = (ours[k] - r).abs().max().item() / (scale or 1.0)
    return gaps


def _write_stage_b_caches(data, root):
    """The flagship cache on disk as Stage A writes it: metadata.csv in the
    Waterbirds layout, clip.npz, clip_{class,spurious,group}.json."""
    from debiasing_multi_modal_tpu_torch.data.embeddings_store import (
        save_embeddings,
        save_text_embeddings,
    )

    meta, table, text_class, text_group, text_spurious = data
    rows = ["img_id,img_filename,y,split,place"] + [
        f"{i},{fn},{y},{s},{p}" for i, (fn, y, s, p) in
        enumerate(zip(meta.filenames, meta.y, meta.split, meta.place))]
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "metadata.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    save_embeddings(os.path.join(root, "RN50", "clip.npz"), table, fmt="npz")
    for kind, text in (("class", text_class), ("spurious", text_spurious),
                       ("group", text_group)):
        save_text_embeddings(os.path.join(root, f"clip_{kind}.json"),
                             [f"{kind} prompt {c}" for c in range(text.shape[1])], text.T)


def _stage_b_cli(data, cfg, card_best_test):
    """cli/train_main.py --device cuda once on the flagship caches."""
    import io

    from debiasing_multi_modal_tpu_torch.cli import train_main

    with tempfile.TemporaryDirectory() as tmp:
        _write_stage_b_caches(data, tmp)
        args = train_main.build_parser().parse_args([
            "--dataset", "waterbirds", "--data_dir", tmp,
            "--image_embedding_dir", os.path.join(tmp, "RN50", "clip.npz"),
            "--text_embedding_dir", os.path.join(tmp, "clip_class.json"),
            "--text_spurious_embedding_dir", os.path.join(tmp, "clip_spurious.json"),
            "--text_group_embedding_dir", os.path.join(tmp, "clip_group.json"),
            "--tl_method", cfg.tl_method, "--add_adapter", "--warm_reg",
            "--epochs", str(cfg.epochs),
            "--epochs_feature_learning", str(cfg.epochs_feature_learning),
            "--batch_size", str(cfg.batch_size), "--batch_size_reg", str(cfg.batch_size_reg),
            "--learning_rate", str(cfg.learning_rate),
            "--learning_rate_reg", str(cfg.learning_rate_reg),
            "--lr_decay_rate", str(cfg.lr_decay_rate), "--lr_decay_epochs", "90,95",
            "--random_seed", str(cfg.random_seed), "--save_results",
            "--results_dir", os.path.join(tmp, "results"), "--device", "cuda"])
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = train_main.main(args)
        seconds = time.perf_counter() - t
        results = sorted(os.listdir(os.path.join(tmp, "results")))
    lines = out.getvalue().splitlines()
    best_test = next(line for line in lines if line.startswith("best test:"))
    worst = float(re.search(r"'worst_acc': ([0-9.]+)", best_test).group(1))
    return {"rc": rc, "seconds": seconds, "results_files": results, "best_test_line": best_test,
            "worst_gap_vs_library_run": abs(worst - card_best_test["worst_acc"])}


def _celeba_epoch(cfg_flags):
    """One train_epoch and one eval_epoch at CelebA scale on the card: the
    timed epoch (plan upload included) under the sync check, launches per
    step from the profiler over 32 steps."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.data.samplers import epoch_plan
    from debiasing_multi_modal_tpu_torch.train import steps
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
    from debiasing_multi_modal_tpu_torch.train.loop import make_classifier
    from debiasing_multi_modal_tpu_torch.train.schedules import epoch_batch_lrs
    from debiasing_multi_modal_tpu_torch.utils.profiling import kernel_breakdown
    from debiasing_multi_modal_tpu_torch.utils.staging import upload

    n, d, bs = CELEBA_TRAIN_ROWS, cfg_flags["input_dim"], 128
    cfg = TrainConfig(tl_method="adapter", dataset="celeba", input_dim=d, batch_size=bs)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    emb = torch.randn(n, d, device="cuda", generator=gen)
    y = torch.randint(0, 2, (n,), device="cuda", generator=gen, dtype=torch.int32)
    groups = y * 2 + torch.randint(0, 2, (n,), device="cuda", generator=gen, dtype=torch.int32)
    text = torch.randn(d, 2, device="cuda", generator=gen)
    state = steps.init_train_state(
        make_classifier(cfg, torch.Generator().manual_seed(SEED)).cuda())
    mask_tree = steps.ones_mask(state.params)
    plan = epoch_plan(n, bs, True, np.random.default_rng(SEED))
    lrs = epoch_batch_lrs(cfg, 1, plan.num_batches, 1)

    def epoch(rows=None):
        idx, msk = plan.indices[:rows], plan.mask[:rows]
        return steps.train_epoch(state, emb, y, groups, upload(idx, emb.device),
                                 upload(msk, emb.device), lrs[:rows], text, mask_tree)[1]

    epoch(16)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    with no_host_sync():
        stats = epoch()
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    device_ms = start.elapsed_time(end)
    profile = kernel_breakdown(lambda: epoch(32), reps=2, top=8)

    val = emb[:CELEBA_VAL_ROWS]
    eplan = epoch_plan(CELEBA_VAL_ROWS, bs, False)
    eidx, emsk = upload(eplan.indices, emb.device), upload(eplan.mask, emb.device)

    def evaluate():
        return steps.eval_epoch(state.module, val, y, groups, eidx, emsk, text)

    evaluate()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with no_host_sync():
        evaluate()
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t) * 1e3
    eval_profile = kernel_breakdown(evaluate, reps=2, top=4)
    finite = all(torch.isfinite(p).all().item() for p in state.params.values())
    return {"rows": n, "dim": d, "batch_size": bs, "steps": plan.num_batches,
            "table_mb": emb.numel() * 4 / 1e6, "epoch_ms_host_clock": host_ms,
            "epoch_ms_device_events": device_ms, "rows_per_s": n / host_ms * 1e3,
            "step_ms": host_ms / plan.num_batches,
            "launches_per_step": profile["kernel_launches_per_call"] / 32,
            "idle_share_32_steps": profile["idle_share"],
            "device_busy_ms_per_step": profile["device_busy_ms_per_call"] / 32,
            "top_kernels_32_steps": profile["top_kernels_ms_per_call"],
            "eval_rows": CELEBA_VAL_ROWS, "eval_ms_host_clock": eval_ms,
            "eval_launches_per_step": eval_profile["kernel_launches_per_call"]
            / eplan.num_batches,
            "counts_exact": stats.counts.sum().item() == n, "params_finite": finite}


def phase_stage_b():
    """Stage B on the card (see the module docstring); returns the launch
    counts of its main path (no kernel of the port runs there)."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.data.synthetic import (
        SyntheticSpec,
        make_synthetic_dataset,
    )
    from debiasing_multi_modal_tpu_torch.train.checkpoint import load_checkpoint
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
    from debiasing_multi_modal_tpu_torch.train.loop import train_all_epochs

    cfg = TrainConfig(**STAGE_B_FLAGS)
    data = make_synthetic_dataset(SyntheticSpec(**STAGE_B_SPEC, seed=SEED))
    bundles = {dev: _stage_b_bundle(data, dev) for dev in ("cuda", "cpu")}
    init = _stage_b_init(cfg)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = {dev: os.path.join(tmp, dev) for dev in ("cuda", "cpu")}
        kw = dict(verbose=False, init=init, checkpoint_every=1, checkpoint_keep=cfg.epochs)

        # ---- the main path, with every launch count at 0 just before it
        _zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        card = train_all_epochs(cfg, bundles["cuda"], checkpoint_dir=ckpt["cuda"], device="cuda",
                                **kw)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        launches = _read_counts()
        # ----
        _expect_counts("stage_b", launches, {})
        t = time.perf_counter()
        cpu = train_all_epochs(cfg, bundles["cpu"], checkpoint_dir=ckpt["cpu"], device="cpu", **kw)
        cpu_s = time.perf_counter() - t

        gaps = {}
        for epoch in (1, cfg.epochs):
            saved = {dev: load_checkpoint(os.path.join(ckpt[dev], f"ep{epoch:05d}"))
                     for dev in ckpt}
            assert saved["cuda"][0] == saved["cpu"][0] == epoch
            gaps[epoch] = _payload_gaps(saved["cuda"][1], saved["cpu"][1])
    param_gap = max(gaps[1].values())
    final_gap = max(gaps[cfg.epochs].values())
    acc_gap = max(abs(a[key] - b[key])
                  for split in ("train", "val", "test")
                  for a, b in zip(card[2][split], cpu[2][split]) for key in a)
    worst_gap = abs(card[0][2]["worst_acc"] - cpu[0][2]["worst_acc"])
    finite = all(np.isfinite(v) for split in card[2].values() for row in split
                 for v in row.values())
    checks = {"epoch1_state_max_rel_gap": param_gap,
              "epoch1_state_worst_tensor": max(gaps[1], key=gaps[1].get),
              "final_state_max_rel_gap": final_gap,
              "final_state_worst_tensor": max(gaps[cfg.epochs], key=gaps[cfg.epochs].get),
              "final_state_tensors": len(gaps[cfg.epochs]),
              "per_epoch_acc_max_gap": acc_gap,
              "selected_test_worst_acc_gap": worst_gap,
              "card_best_test": card[0][2], "cpu_best_test": cpu[0][2],
              "card_zero_shot": card[1], "history_finite": finite,
              "epochs": len(card[2]["test"])}
    emit({"phase": "stage_b", "config": {**STAGE_B_FLAGS, "lr_decay_epochs": [90, 95]},
          "data": {**STAGE_B_SPEC, "seed": SEED}, "launches": launches,
          "perf": {"card_run_s": card_s, "cpu_run_s": cpu_s}, "checks": checks})
    if not (finite and checks["epochs"] == cfg.epochs and param_gap <= 1e-4
            and final_gap <= FINAL_STATE_LIMIT and acc_gap <= 5e-3 and worst_gap <= 1e-2):
        raise AssertionError(f"Stage B on the card disagrees with the CPU: {checks}")
    del bundles

    celeba = _celeba_epoch(STAGE_B_FLAGS)
    emit({"phase": "stage_b", "celeba_scale_epoch": celeba})
    if not (celeba["counts_exact"] and celeba["params_finite"]):
        raise AssertionError(f"CelebA-scale epoch: {celeba}")

    cli = _stage_b_cli(data, cfg, card[0][2])
    emit({"phase": "stage_b", "cli": cli})
    if not (cli["rc"] == 0 and len(cli["results_files"]) == 2
            and cli["worst_gap_vs_library_run"] <= 1e-2):
        raise AssertionError(f"train_main on the card: {cli}")
    return {"stage_b": launches}


F32_DESIGN = ("f32 on the CUDA cores from register tiles (attention_f32.cuh: 16x16 threads, "
              "4x8 logits and 4x4 outputs a thread at 64 query rows, 16-byte cp.async into "
              "swizzled shared memory, warp-per-row exact softmax)")
TC_DESIGN = ("CUDA C++; bf16 on the tensor cores (mma.sync.m16n8k16, ldmatrix, 16-byte "
             "cp.async into swizzled shared memory); " + F32_DESIGN)
QTILED_DESIGN = ("CUDA C++; " + F32_DESIGN + ", K/V streamed through double-buffered key "
                 "tiles; bf16 the first design (one warp per 4 rows, CUDA cores)")
FLASH_BWD_DESIGN = ("CUDA C++; bf16 on the tensor cores (mma.sync.m16n8k16 with f32 "
                    "accumulators, ldmatrix/ldmatrix.trans, double-buffered 16-byte cp.async "
                    "into swizzled shared memory, p and ds rounded in registers; kernel 6 "
                    "computes the transposed products); f32 the same pattern as split-TF32 "
                    "(flash_f32_tc.cuh: three mma.sync.m16n8k8 TF32 products per product, "
                    "hi/lo split on each fragment load, p and ds kept in registers)")
FLASH_FWD_DESIGN = ("CUDA C++; bf16 on the tensor cores (mma.sync.m16n8k16 with f32 "
                    "accumulators, Q fragments held in registers, ldmatrix/ldmatrix.trans, "
                    "double-buffered 16-byte cp.async into swizzled shared memory, the online "
                    "softmax in registers with p rounded in the accumulator layout); f32 the "
                    "same pattern as split-TF32 (flash_f32_tc.cuh: three mma.sync.m16n8k8 "
                    "TF32 products per product, the online softmax per 32-key sub-tile, p "
                    "kept in registers as the A fragment of P.V, one K/V buffer and Q re-read "
                    "from shared memory so that four blocks share an SM)")
BOTTLENECK_DESIGN = ("CUDA C++; bf16 on the tensor cores: each phase an implicit GEMM "
                     "(rows pixels, columns channels) on mma.sync.m16n8k16 with f32 "
                     "accumulators, 32x64 warp tiles, weights (and x for conv1 and the "
                     "downsample) staged in 32-deep k-tiles through a ring of four swizzled "
                     "buffers by 16-byte cp.async, conv2 and conv3 reading A by ldmatrix straight "
                     "from the swizzled y1 / y2 tiles at each lane's shifted pixel; f32 on "
                     "CUDA-core FMAs")
INT8_DESIGN = ("CUDA C++; wgmma.mma_async m64n128k32 s8 from 128-byte-swizzled shared "
               "memory, fed by TMA (cp.async.bulk.tensor.2d) through a 3-stage mbarrier "
               "ring from one producer warp, two consumer warpgroups per 128x128 tile, the "
               "f32 epilogue staged in shared memory and stored in 16-byte rows")


def _kernel_line(name, source, replaces, cases, launches_by_path, card, design=None):
    main = next(c for c in cases if "ms" in c)
    by_path = {path: counts[name] for path, counts in launches_by_path.items()}
    line = {
        "name": name,
        "route": "cuda",
        "source": f"debiasing_multi_modal_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main["ms"],
        "kernel_ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library_call": main["library_call"],
        "shape": main["shape"],
        "card": card,
    }
    for key in ("events_ms", "library2_ms", "library2_call"):
        if key in main:
            line[key] = main[key]
    if design:
        line["design"] = design
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=["flash_f32", "rn50_blocks", "stage_b"],
                        help="flash_f32: build, then only the timed f32 cases of kernels 4-6 "
                             "and the f32 128-pair training step; rn50_blocks: build, fold "
                             "the seeded RN50, then only the rn50_blocks phase (kernels 8-9); "
                             "either times another tree's kernels with this script; "
                             "stage_b: only the stage_b phase (no kernel to build); none "
                             "prints the final line")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    info = phase_device()
    if args.only == "flash_f32":
        import torch

        phase_build(check=False)
        _flash_cases(torch.Generator(device="cuda").manual_seed(SEED), f32_only=True)
        phase_train(f32_only=True)
        emit({"phase": "summary", "only": args.only, "seconds": time.perf_counter() - t0})
        return 0
    if args.only == "stage_b":
        phase_stage_b()
        emit({"phase": "summary", "only": args.only, "seconds": time.perf_counter() - t0})
        return 0
    if args.only == "rn50_blocks":
        import numpy as np
        import torch

        phase_build(check=False)
        _, folded, _ = _fold_rn50(np.random.default_rng(SEED + 3))
        phase_rn50_blocks(folded(torch.bfloat16, "cuda"))
        emit({"phase": "summary", "only": args.only, "seconds": time.perf_counter() - t0})
        return 0
    phase_build()
    cases = phase_kernels()
    launches, slice_perf = phase_slice()
    fuse_launches, folded = phase_fuse_bn(slice_perf)
    launches.update(fuse_launches)
    block_launches, block_cases = phase_rn50_blocks(folded)
    launches.update(block_launches)
    cases.update(block_cases)
    del folded
    launches.update(phase_vit())
    launches.update(phase_qtiled())
    launches.update(phase_train())
    launches.update(phase_stage_b())
    emit({"phase": "summary", "seconds": time.perf_counter() - t0})
    card = info["nvidia_smi"]
    emit({"kernels": [
        _kernel_line("short_attention", "short_attention.cu",
                     "debiasing_multi_modal_tpu/ops/short_attention.py:218",
                     cases["short_attention"], launches, card, TC_DESIGN),
        _kernel_line("short_attention_qtiled", "short_attention_qtiled.cu",
                     "debiasing_multi_modal_tpu/ops/short_attention.py:308",
                     cases["short_attention_qtiled"], launches, card, QTILED_DESIGN),
        _kernel_line("short_attention_packed", "short_attention.cu",
                     "debiasing_multi_modal_tpu/ops/short_attention.py:269",
                     cases["short_attention_packed"], launches, card, TC_DESIGN),
        _kernel_line("int8_matmul", "quant_gemm.cu",
                     "debiasing_multi_modal_tpu/ops/quant_gemm.py:36",
                     cases["int8_matmul"], launches, card, INT8_DESIGN),
        _kernel_line("flash_attention", "flash_attention.cu",
                     "debiasing_multi_modal_tpu/ops/flash_attention.py:180",
                     cases["flash_attention"], launches, card, FLASH_FWD_DESIGN),
        _kernel_line("flash_attention_dq", "flash_attention.cu",
                     "debiasing_multi_modal_tpu/ops/flash_attention.py:244",
                     cases["flash_attention_dq"], launches, card, FLASH_BWD_DESIGN),
        _kernel_line("flash_attention_dkv", "flash_attention.cu",
                     "debiasing_multi_modal_tpu/ops/flash_attention.py:298",
                     cases["flash_attention_dkv"], launches, card, FLASH_BWD_DESIGN),
        _kernel_line("fused_bottleneck_gemm", "bottleneck.cu",
                     "debiasing_multi_modal_tpu/ops/conv_gemm.py:44",
                     cases["fused_bottleneck_gemm"], launches, card, BOTTLENECK_DESIGN),
        _kernel_line("fused_bottleneck", "bottleneck.cu",
                     "debiasing_multi_modal_tpu/ops/fused_bottleneck.py:41",
                     cases["fused_bottleneck"], launches, card, BOTTLENECK_DESIGN),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
