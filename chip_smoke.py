#!/usr/bin/env python3
"""Drive the PyTorch port (debiasing_multi_modal_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only flash_f32   # the timed f32 flash cases and the
                                             # f32 training step alone
    python3 chip_smoke.py --only qtiled_bf16 # bf16 kernel 2 alone (S=1025 timed,
                                             # ragged S past kernel 1's gate)
    python3 chip_smoke.py --only rn50_blocks # kernels 8 and 9 at the folded RN50's
                                             # stride-1 blocks alone
    python3 chip_smoke.py --only vitl14_336_bf16  # kernel 1 at ViT-L/14@336px's
                                             # image shape and its bf16 batch alone
    python3 chip_smoke.py --only stage_b     # Stage B (adapter training) alone
    python3 chip_smoke.py --only contrastive # the contrastive adapter alone
    python3 chip_smoke.py --only sweep       # the stacked seed-and-grid sweep alone
    python3 chip_smoke.py --only native_json # the native clip.json parser alone
    python3 chip_smoke.py --only parallel    # the world-size-1 parallel paths alone
    python3 chip_smoke.py --only leaves      # the side modules alone
    python3 chip_smoke.py --only reproduce   # the reproduction chain alone

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
             kernels 5 and 6 (bf16 and f32) at hd 32 and 64, kernel 7, bf16
             kernel 2 and the six instantiations of kernels 8-9 (bf16 and
             split-TF32 f32) at all, f32 kernels 1-3 (every tile) at hd 32
             and 64.
3. kernels — hold each kernel against its plain PyTorch version on the card
             at the main paths' shapes, and time kernel, plain version and the
             PyTorch library call that computes the same function (yardstick
             only; the port never calls it): kernel 1 (whole-row attention;
             bf16 on the tensor cores, timed at the text and ViT-B/32 image
             shapes and ViT-L/14@336px's image shape, B=256 S=577 D=1024
             H=16, its two-pass route, f32 on the CUDA cores, register-tiled, at the RN50 and
             ViT-L/14@336px text shapes and the ViT-L/14 image shape; the attention
             kernels, their plain versions and SDPA timed by CUDA-graph replay,
             so a wrapper's host time stays out), kernel 2
             (q-tiled; f32 the same register-tiled code with K/V streamed;
             bf16 kernel 1's tensor-core two-pass path with K/V streamed, on
             no main path, timed at ViT-L/14@448's S=1025, with ragged bf16 S
             from 833 to each gate's largest, 1,750 / 1,686 / 1,558 at hd 32
             / 64 / 128, causal and not), kernel 3 (packed, timed at both
             shapes), with ragged
             bf16 S from 1 to the gate's largest (832 at hd 64) for kernels 1
             and 3, ragged f32 S from 1 to each gate's largest (348 and 1,624
             at hd 64; 592 / 1,720 at hd 32, 184 / 1,432 at hd 128) for
             kernels 1, 3 and 2, and the order checks (kernel 3 bit-equal to
             kernel 1 in both dtypes, kernel 2 bit-equal to kernel 1 in f32
             and, where kernel 1 takes its two-pass path, in bf16; at S=77
             within the bf16 limits), kernel 7 (int8 GEMM on wgmma fed by TMA,
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
             (bf16: mma.sync on the tensor cores); f32 (split-TF32 on the
             tensor cores, on no main path) at l1b1, l2b1, l3b1 and l4b1 on 8
             images, each within 1e-4 of scale of the plain version and
             cosine 0.999 of the model's block run in f32, timed beside both
             (kernel 8 at every strip and images per block that fit, the
             fastest kept).
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
             Then vitl14_336_bf16: the same model at the extraction CLI's
             card dtype, bf16: 256 prompts encoded, then the counts set to 0
             and one uint8 [256, 218, 178, 3] batch (CelebA's aligned size,
             resized on the card to 336) through ExtractionRunner.encode_batch,
             then the counts read: kernel 1 once a block (24), kernels 2 and 4
             never; the image embeddings within cosine 0.999 of the plain
             attention formulation's; imgs/s.
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
11. contrastive — the contrastive adapter (TrainConfig defaults: 64 positives,
             64 negatives, batch_factor 4; ca_head="linear", a whole CE epoch
             after each SupCon epoch) on the same D=1024 Waterbirds-size cache,
             6 epochs: train_all_epochs on the card with the counts set to 0
             (all stay 0), then on the CPU from the same initial state (the
             head's included), held to each other as stage_b's runs are, the
             per-epoch SupCon losses beside; then one contrastive epoch under
             the sync check: ms, steps, rows/s, launches per step and idle
             share (profiler, 32 steps), and the same epoch stacked three
             rows deep (the sweep's form) under the sync check.
12. sweep  — the stacked sweep: the grid of scripts/run_sweep_wb.sh
             (adapter_reg_seq_alter --add_adapter --warm_reg, lr {1, 10} x bs
             {512, 1024} x bsr {64, 128, 256, 512} x seeds {42, 32, 22}: 48
             rows, all three axes stacked into one program) on the D=1024
             Waterbirds-size cache, 6 epochs across the phase switch, through
             run_sweep with the counts set to 0 (all stay 0); three rows held
             to their sequential train_all_epochs on the card (best-epoch and
             zero-shot dicts within 5e-3, the selected test worst-group
             accuracy within 1e-2); the stacked wall seconds beside the three
             sequential runs' seconds scaled to 48 rows; the grid's stacked
             phase-1 and reg epochs timed under the sync check, and 32 of each
             one's steps profiled (launches per step, idle share).  Then the
             grid of scripts/run_sweep_ca.sh at CelebA scale (162,770 x 1024
             on the card; lr 0.1 x bs 1024 x bsr {4, 8, 16} x seeds {42, 32}:
             6 rows): one stacked phase-1 epoch (159 steps) and one stacked reg
             epoch over the 9,933-row reg half (the bsr-4 rows set 2,484
             steps; only the first 512 are timed if the whole would pass
             30 s), both under the sync check.  Then cli/sweep_main.py
             --device cuda on a small cache: one CSV per cell.
13. native_json — the native clip.json parser and writer (native/ebdjson.cpp,
             built with g++ into the port's build directory): a
             Waterbirds-size cache (11,788 rows at RN50's D = 1024, seeded)
             written by the store, loaded by the native parser and by the
             Python parser (equal tables, both times), and the flagship
             Stage-B run through cli/train_main.py from the JSON cache and
             from the .npz (the same best-epoch line).  Fails if the library
             did not build or the Python parser ran.
14. parallel — a world-size-1 NCCL group on the card: ViT-B/32 at full width,
             batch 256, through the data-parallel and the tensor-parallel
             (tp = 1) extraction paths against the unsharded runner (kernel
             1's launches as on the unsharded path: 12 per batch), Stage B
             on the flagship configuration through shard_bundle, the 48-row
             Waterbirds grid with the seed mesh (both timed in turns with
             their unsharded runs: unsharded, sharded, sharded, unsharded),
             ring and Ulysses attention at B=4 S=4096 H=16 hd=64 bf16
             against plain attention, each timed beside its unsharded run;
             then kernel 1 at the tp = 2 and 4
             shard shapes of ViT-B/32 (image 6 / 3 heads at D = 384 / 192,
             text 4 / 2 heads at D = 256 / 128) and kernel 7 at its tp shard
             shapes (N = 192 padded to 256 by ops/quant.int8_matmul_padded),
             each against its plain version.  Then the pipeline schedule
             (parallel/pp.py) on a ("data", "stage", "model", "seq") mesh of
             shape (1, 1, 1, 1), bf16, 4 microbatches: the RN50 text tower
             (256 prompts of 77 tokens) and the ViT-B/32 image tower (256
             images, S = 50) pipelined against the same model's unpipelined
             encode (cosine >= 0.999, max error, prompts/s or imgs/s beside
             the unpipelined rate, kernel 1's launches: 12 layers x 4
             microbatches = 48 each; the ViT encode under the sync check),
             the ViT encode once more through the manual tp/sp block (model
             and seq axes set, ring attention at size 1; cosine >= 0.999),
             and one loss through pipeline_transformer on 128 images with
             remat off and on against the unpipelined tower's gradients
             (cosine >= 0.99 per parameter, >= 0.999 flattened; remat within
             1e-6 of scale of remat off; kernel 1 48 / 96 launches, its
             backward the plain VJP).  NCCL cannot put two ranks on
             one card, so the multi-rank checks run as CPU processes in the
             tests (parallel/dryrun.py).
15. leaves — the side modules on the card against the CPU, no kernel
             launched (every count stays 0 through the first four):
             entry() (f32 predictions equal, the bf16 default's features
             cosine >= 0.999), train_augment's crop and flip of 256 uint8
             256x256 images to 224 at given boxes (within 1e-5 of scale;
             imgs/s), a plain ResNet-50 train-mode SGD step at batch 64 in
             f32 (output and running statistics within 1e-3 of scale,
             gradients cosine >= 0.99 per parameter and >= 0.999 flattened,
             the f64 step on the card beside) and its bf16 forward imgs/s at
             batch 256, linear_probe on a CelebA-size table (162,770 x 1024,
             2 epochs: weights within 1e-4 of scale, accuracy within 5e-3;
             one epoch under the sync check, rows/s) and adapted_embeddings
             of 32,768 of its rows (within 1e-5 of scale); then zoo.load of
             a seeded ViT-B/32 archive written by save_jit_state_dict_archive
             (its encode equal to clip_from_state_dict's; kernel 1 runs in
             these encodes).
16. reproduce — the reproduction chain (scripts/reproduce_all_torch.sh) on the
             card at RN50's full widths: the synthetic fixture
             (scripts/make_synthetic_fixture.py --skip_checkpoint, 64 images a
             split) and a seeded RN50 checkpoint
             (scripts/make_synthetic_checkpoint_torch.py --geometry RN50),
             a synthetic merges file, then the chain with REPRO_DEVICE=cuda,
             no ablations and 3-epoch one-seed sweeps over the real grids,
             each grid stacked into one program:
             both extractions (kernel 1: 12 launches per text encode, read
             from each extract_main's "kernel launches" line; no other
             kernel), both headline CSVs, the tables and the structural
             check.  The card's Stage-A caches are held to extract_main
             --device cpu on the same fixture and checkpoint (predictions
             >= 99 % equal, image embeddings and text JSONs cosine >= 0.999
             per row).  Each stage's wall seconds and the chain's.
17. summary — the wall seconds, one {"kernels": [...]} line, the card line, and
             {"ok": true, "device": {...}} as the last line.
"""

import argparse
import contextlib
import copy
import json
import os
import re
import subprocess
import sys
import tempfile
import time

from debiasing_multi_modal_tpu_torch.utils.timing import graph_ms, time_ms

# Published H100 SXM peaks (NVIDIA data sheet, dense), for bound_ms.
HBM_BYTES_PER_S = 3.35e12
EXP2_PER_S = 3.9e12  # exp2f on the SFUs: 16 a clock per SM, 132 SMs, ~1.85 GHz
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
PEAK_TF32_FLOPS = 495e12  # f32 kernels 4-6, 8-9: three TF32 products per product
PEAK_INT8_OPS = 1979e12
SEED = 0
BF16_ULP = 2.0 ** -8


def emit(obj):
    print(json.dumps(obj), flush=True)


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
    """Build every kernel and print the registers and spills of kernels 1-3,
    of every flash instantiation, of kernel 7 and of kernels 8-9; with
    ``check``, fail on the spills listed in the module docstring."""
    from debiasing_multi_modal_tpu_torch.ops import cuda_build

    seconds = cuda_build.build_all()
    emit({"phase": "build", "kernels": cuda_build.kernel_names(),
          "seconds": seconds})
    # registers and spills (nvcc -Xptxas=-v)
    usage = {}
    for lib, source in (("short_attention", "short_attention.cu"),
                        ("short_attention_qtiled", "short_attention_qtiled.cu"),
                        ("flash_attention", "flash_attention.cu"),
                        ("quant_gemm", "quant_gemm.cu"), ("bottleneck", "bottleneck.cu")):
        usage[lib] = cuda_build.ptxas_usage(lib)
        emit({"phase": "build", "ptxas": source, "functions": usage[lib]})
    if not check:
        return
    # bf16 kernel 4 at every hd, f32 kernel 4 and bf16 and f32 kernels 5-6
    # at hd 32/64 (f32 all split-TF32), kernel 7, every f32 kernel-1
    # (resident) and kernel-2 (streamed) tile at hd 32/64, the three bf16
    # kernel-2 instantiations and the six of kernels 8-9 (bf16 and
    # split-TF32 f32)
    must_not_spill = (r"fwd_tc_kernelILi(32|64|128)E|(fwd|dq|dkv)_f32tc_kernelILi(32|64)E"
                      r"|(dq|dkv)_tc_kernelILi(32|64)E|int8_gemm|f32_attn_kernelILi(32|64)E"
                      r"|qtiled_tc_kernel|bottleneck_tc_kernel")
    checked = [row for rows in usage.values() for row in rows
               if re.search(must_not_spill, row["function"])]
    if set(usage) - set(cuda_build.build_logs):
        emit({"phase": "build", "ptxas": "libraries built by an earlier run: not re-read"})
    elif len(checked) != 3 + 6 + 4 + 2 + 2 * (2 + 3) + 3 + 6:
        raise AssertionError(f"expected 34 no-spill instantiations, found {len(checked)}")
    spilled = [row["function"] for row in checked
               if row.get("spill_store_bytes") or row.get("spill_load_bytes")]
    if spilled:
        raise AssertionError(f"kernels that must not spill registers do: {spilled}")


def _attention_bound_ms(b, s, d, h, causal, dtype, itemsize, passes=1):
    """The least time of the function: 4 flops per (query, key, head dim),
    QK^T and PV, against each tensor read or written once.  ``passes=2``
    counts a two-pass kernel's work instead (QK^T twice: 6 flops)."""
    pairs = h * (s * (s + 1) // 2 if causal else s * s)  # (query, key) pairs per image
    flops = (2 + 2 * passes) * b * pairs * (d // h)      # 2 flops per MAC
    bytes_ms = 4 * b * s * d * itemsize / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


def _exp_bound_ms(b, s, h, causal):
    """The exponentials' least time in a two-pass kernel: two exp2f per
    (query, key) pair and head, at :data:`EXP2_PER_S` (informational: the
    roofline bound above counts bytes and flops only)."""
    pairs = h * (s * (s + 1) // 2 if causal else s * s)
    return 2 * b * pairs / EXP2_PER_S * 1e3


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
                    timed, packed=False, twin=None):
    """One attention kernel against its plain version (and float64); timed
    cases add the kernel's, the plain version's and SDPA's times.  ``twin``:
    another kernel of the same function that must equal this one bit for bit
    on these inputs (timed beside it in timed cases)."""
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
           "scale": ref.float().abs().max().item(), "cosine": cos,
           "kernel_err_vs_f64": (out.double() - exact).abs().max().item(),
           "plain_err_vs_f64": (ref.double() - exact).abs().max().item()}
    del exact
    if not (err <= tol and (dtype == torch.float32 or cos >= 0.9999)):
        raise AssertionError(f"{kernel.__name__} disagrees with its plain version: {row}")
    if twin is not None:
        row[f"equals_{twin.__name__}"] = bool(torch.equal(out, twin(*args, causal=causal)))
        if not row[f"equals_{twin.__name__}"]:
            raise AssertionError(f"{kernel.__name__} differs from {twin.__name__}: {row}")
        if timed:
            row[f"{twin.__name__}_ms"] = graph_ms(lambda: twin(*args, causal=causal))
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
        row["two_pass_bound_ms"] = _attention_bound_ms(
            b, s, d, h, causal, dtype, q.element_size(), passes=2)[0]
        row["two_pass_exp_bound_ms"] = _exp_bound_ms(b, s, h, causal)
    emit({"phase": "kernels", "kernel": kernel.__name__, **row})
    return row


# Ragged bf16 S at hd 64 for kernels 1 and 3: one key chunk in registers (1,
# 17, 50, 77), two passes over 64-key chunks (129, 257, 577), and the gate's
# largest S (832); causal and not.
RAGGED_S = [(f"ragged_s{s}_{'causal' if causal else 'noncausal'}_bf16", 3, s, 512, 8, causal)
            for s in (1, 17, 50, 77, 129, 257, 577, 832) for causal in (False, True)]


# ViT-L/14@336px's image attention at the extraction's batch: S = 577 takes
# kernel 1's long-row route (two passes over 64-key chunks), timed beside
# kernel 2, which must equal it bit for bit; (label, B, S, D, H, causal)
VITL14_336_IMAGE = ("vitl14_336_image_bf16", 256, 577, 1024, 16, False)


# Ragged f32 S at hd 64 (D=512, H=8), causal and not: kernels 1 and 3 up to
# their gate's largest S (348), kernel 2 at every S up to its gate's (1,624).
RAGGED_F32_S = (1, 31, 33, 63, 65, 129, 348, 417, 418, 1111, 1624)
RAGGED_F32 = [(f"ragged_s{s}_{'causal' if causal else 'noncausal'}_f32", 3, s, 512, 8, causal)
              for s in RAGGED_F32_S for causal in (False, True)]


# bf16 kernel 2 past bf16 kernel 1's gate (832 at hd 64), on no main path:
# ragged against its 16-row warp tiles, 64-key chunks and 128-row q tiles
# (833, 900, 1111), causal, hd 32 / 64 / 128 up to each gate's largest S
# (1,750 / 1,686 / 1,558); (label, B, S, D, H, causal)
QTILED_BF16 = [("ragged_s833_bf16", 3, 833, 512, 8, False),
               ("ragged_s1111_causal_bf16", 2, 1111, 512, 8, True),
               ("gate_largest_hd64_bf16", 2, 1686, 512, 8, False),
               ("gate_largest_hd64_causal_bf16", 2, 1686, 512, 8, True),
               ("ragged_s900_hd32_bf16", 3, 900, 256, 8, False),
               ("gate_largest_hd32_causal_bf16", 2, 1750, 256, 8, True),
               ("ragged_s1025_hd128_causal_bf16", 2, 1025, 512, 4, True),
               ("gate_largest_hd128_bf16", 2, 1558, 512, 4, False)]


def _qtiled_bf16_cases(gen):
    """bf16 kernel 2: timed at ViT-L/14@448's image shape (S=1025) beside
    its plain version and SDPA, then the ragged cases, each within 2e-2,
    1e-2 of the plain version's scale and cosine 0.9999 of it."""
    import torch

    from debiasing_multi_modal_tpu_torch.ops import short_attention as sa

    bf16 = torch.bfloat16
    rows = [_attention_case(sa.short_attention_qtiled, sa.short_attention_reference, *case,
                            bf16, 2e-2, gen, timed)
            for *case, timed in [("vitl14_448_bf16", 4, 1025, 1024, 16, False, True),
                                 *[(*c, False) for c in QTILED_BF16]]]
    bad = [r["case"] for r in rows if not r["max_abs_err"] <= 1e-2 * r["scale"]]
    if bad:
        raise AssertionError(f"bf16 kernel 2 off by more than 1e-2 of scale: {bad}")
    return rows


def _order_checks(gen):
    """Kernel 3 runs kernel 1's device code, so the two are bit-equal in both
    dtypes; kernel 2 sums in kernel 1's f32 order (bit-equal in f32), and in
    bf16 runs kernel 1's two-pass tensor-core path, so the two are bit-equal
    where kernel 1 takes that path (S > 80 at hd 64, S > 32 at hd 128); at
    S = 77 kernel 1 holds a row's keys in one chunk (another order), and
    kernel 2 is held to the bf16 limits (2e-2, cosine >= 0.9999).
    Comparison launches, not counted as the main path's."""
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
    two_pass = []
    for b, s, d, h in [(8, 577, 512, 8), (4, 832, 512, 8), (4, 1111, 256, 8), (4, 257, 512, 4)]:
        q, k, v = (torch.randn(b, s, d, device="cuda", generator=gen).bfloat16()
                   for _ in range(3))
        for causal in (False, True):
            two_pass.append(torch.equal(sa.short_attention_qtiled(q, k, v, h, causal=causal),
                                        sa.short_attention(q, k, v, h, causal=causal)))
    checks["qtiled_equals_whole_row_bfloat16_two_pass"] = all(two_pass)
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
        int8_matmul_padded,
        quantize_cols_int8,
        quantize_rows_int8,
    )

    x = torch.randn(m, k, device="cuda", generator=gen)
    w = torch.randn(n, k, device="cuda", generator=gen).t()  # a Linear weight's view
    bias = torch.randn(n, device="cuda", generator=gen) if with_bias else None
    qx, sx = quantize_rows_int8(x)
    qk, sk = quantize_cols_int8(w)
    # N not a multiple of 128 (a tp = 4 shard's q/k/v) goes through the
    # caller's padding, as ops/quant.py::int8_dense takes it
    if n % 128 == 0:
        matmul = qg.int8_matmul
    else:
        def matmul(qx, qk, sx, sk, bias, out_dtype):
            return int8_matmul_padded(qx, qk, sx, sk, bias, out_dtype)
    out = matmul(qx, qk, sx, sk, bias, out_dtype=out_dtype)
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
            return matmul(qx, qk, sx, sk, bias, out_dtype=out_dtype)

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
                 (*VITL14_336_IMAGE, bf16, 2e-2, True),
                 ("vitl14_image_f32", 64, 257, 1024, 16, False, f32, 1e-5, True),
                 ("text_vitl14_336_f32", 256, 77, 768, 12, True, f32, 1e-5, True),
                 ("ragged_noncausal_bf16", 5, 50, 768, 12, False, bf16, 2e-2, False),
                 ("ragged_noncausal_f32", 5, 50, 768, 12, False, f32, 1e-5, False),
                 ("gate_largest_hd32_f32", 2, 592, 256, 8, False, f32, 1e-5, False),
                 ("gate_largest_hd128_f32", 2, 184, 512, 4, True, f32, 1e-5, False),
                 *ragged, *whole32]:
        # the long-row route runs kernel 2's two passes: bit-equal to it
        _, _, s, d, h, _, dtype = case[:7]
        twin = (sa.short_attention_qtiled if dtype == bf16 and sa.long_row_route(s, d // h)
                else None)
        results["short_attention"].append(_attention_case(
            sa.short_attention, sa.short_attention_reference, *case[:8], gen, case[8],
            twin=twin))
    for case in [("vitl14_336_f32", 8, 577, 1024, 16, False, f32, 1e-5, True),
                 ("ragged_causal_f32", 3, 1111, 256, 4, True, f32, 1e-5, False),
                 ("gate_largest_hd32_f32", 2, 1720, 256, 8, False, f32, 1e-5, False),
                 ("gate_largest_hd128_f32", 2, 1432, 512, 4, True, f32, 1e-5, False),
                 *ragged32]:
        results["short_attention_qtiled"].append(_attention_case(
            sa.short_attention_qtiled, sa.short_attention_reference, *case[:8], gen,
            case[8]))
    results["short_attention_qtiled"] += _qtiled_bf16_cases(gen)
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


def _zero_counts():
    from debiasing_multi_modal_tpu_torch.ops import kernel_wrappers, short_attention

    for fn in kernel_wrappers().values():
        fn.launches = 0
    short_attention.short_attention.long_row_launches = 0


def _read_counts():
    """``ops.launch_counts()``: each wrapper's launches, and kernel 1's and
    3's calls on the long-row route as ``short_attention.long_row_launches``."""
    from debiasing_multi_modal_tpu_torch.ops import launch_counts

    return launch_counts()


def _expect_counts(path, got, want):
    want = {name: want.get(name, 0) for name in _read_counts()}
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
    the bf16 peak, or in f32 as three TF32 products each at the TF32 peak
    (the kernels' split-TF32 route).  Also returns the operations bound at
    the dtype's PEAK_FLOPS (in f32 the CUDA cores' FMA peak)."""
    import torch

    macs_per_px = cin * m + 9 * m * m + m * cout + (cin * cout if ds else 0)
    weight_bytes = macs_per_px * itemsize + 4 * (2 * m + cout + (cout if ds else 0))
    nbytes = b * h * h * (cin + cout) * itemsize + weight_bytes
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    flops = 2 * b * h * h * macs_per_px
    at_peak_ms = flops / PEAK_FLOPS[str(dtype)] * 1e3
    flops_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3 if itemsize == 4 else at_peak_ms
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations",
            max(bytes_ms, at_peak_ms))


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
                row["bound_ms"], row["bound_by"], _ = _bottleneck_bound_ms(
                    b, h, cin, m, cout, ds, x.element_size())
            emit({"phase": "rn50_blocks", "kernel": kname, **row})
            cases[kname].append(row)
        del plain, model_out

    # f32 (split-TF32 on the tensor cores, on no main path) at l1b1, l2b1,
    # l3b1 and l4b1 on 8 images: both kernels against the plain version and
    # the model's block run in f32 (TF32 off, as the f32 convolutions always
    # run), timed beside both; kernel 8 at every (strip, images per block)
    # that fits, the fastest kept as its time (at 8 images the largest strip
    # leaves SMs idle, and at layers 3-4 every block re-reads all weights),
    # kernel 9 at its own strip, one image per block
    fast = dict(runs=10, calls=5, warmup=2)
    for name in ("l1b1", "l2b1", "l3b1", "l4b1"):
        entry = blocks[name]
        x = entry["x_nhwc"][:8].float()
        w = [t.float() for t in entry["weights"][:6]]
        b, h, _, cin = x.shape
        m, cout = w[0].shape[1], w[4].shape[1]
        block32 = copy.deepcopy(entry["block"])
        block32.dtype = torch.float32
        x_nchw = entry["x"][:8].float()
        tilings = [(s, g) for s in range(1, h + 1) for g in (1, 2, 4, 8)
                   if h % s == 0 and b % g == 0
                   and cg.smem_bytes(h, m, s, g, 4) <= cg.SMEM_LIMIT_BYTES]
        with torch.inference_mode():
            plain = cg.xla_bottleneck(x, *w)
            model32 = block32(x_nchw).permute(0, 2, 3, 1)
            timings = {"plain_ms": time_ms(lambda: cg.xla_bottleneck(x, *w), **fast),
                       "model_block_ms": time_ms(lambda: block32(x_nchw), **fast)}
            by_tiling = {}
            for strip, g in tilings:
                def k8(strip=strip, g=g):
                    return cg.fused_bottleneck_gemm(x, *w, strip_rows=strip, images_per_cell=g)

                err, scale, cos = _block_close(k8(), plain)
                _, _, cos_model = _block_close(k8(), model32)
                by_tiling[strip, g] = {"ms": time_ms(k8, **fast), "max_abs_err": err,
                                       "scale": scale, "cosine": cos,
                                       "cosine_vs_model_block": cos_model}
            best = min(by_tiling, key=lambda sg: by_tiling[sg]["ms"])
            k9_strip = fb.strip_rows(h, h, m, 4)
            out = fb.fused_bottleneck(x, *w)
            err, scale, cos = _block_close(out, plain)
            _, _, cos_model = _block_close(out, model32)
            k9 = {"ms": time_ms(lambda: fb.fused_bottleneck(x, *w), **fast), "max_abs_err": err,
                  "scale": scale, "cosine": cos, "cosine_vs_model_block": cos_model}
        bound = _bottleneck_bound_ms(b, h, cin, m, cout, False, 4)
        for kname, (strip, g), res in (("fused_bottleneck_gemm", best, by_tiling[best]),
                                       ("fused_bottleneck", (k9_strip, 1), k9)):
            row = {"case": f"{name}_f32", "shape": [b, h, h, cin, m, cout], "downsample": False,
                   "dtype": "torch.float32", "strip_rows": strip, "images_per_cell": g,
                   **res, **timings, "library_ms": None,
                   "library_call": "none: no single call computes the block",
                   "bound_ms": bound[0], "bound_by": bound[1], "fma_bound_ms": bound[2]}
            if kname == "fused_bottleneck_gemm":
                row["ms_by_strip_and_images"] = {f"s{s}g{gi}": v["ms"]
                                                 for (s, gi), v in by_tiling.items()}
            for r in (by_tiling.values() if kname == "fused_bottleneck_gemm" else [res]):
                if not (r["max_abs_err"] <= 1e-4 * r["scale"]
                        and r["cosine_vs_model_block"] >= 0.999):
                    bad.append(f"{kname} {name}_f32")
            emit({"phase": "rn50_blocks", "kernel": kname, **row})
            cases[kname].append(row)
        del block32, plain, model32
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


def phase_vitl14_336_bf16():
    """ViT-L/14@336px at the extraction CLI's card dtype, bf16: every image
    attention is kernel 1 on its long-row route (S = 577), 24 launches a
    batch, all 24 counted in ``short_attention.long_row_launches``, and
    kernels 2 and 4 never run.  The launch counts are set to 0
    after the text encode and read after one ``encode_batch`` of 256 uint8
    218 x 178 images; the embeddings are held to the same weights under the
    plain attention formulation (cosine >= 0.999, as ViT-B/32's)."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.extract.runner import ExtractionRunner
    from debiasing_multi_modal_tpu_torch.models import create_clip

    def build(**kw):
        return create_clip("ViT-L/14@336px", device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(SEED), **kw)

    rng = np.random.default_rng(SEED + 6)
    model = build()
    tokens = torch.from_numpy(_tokens(256, rng)).cuda()
    images = rng.integers(0, 256, (256, 218, 178, 3), dtype=np.uint8)
    with torch.inference_mode():
        zs = model.encode_text(tokens)[:2].float().cpu().numpy()
    runner = ExtractionRunner(model, zs)
    # ---- the image batch, with every launch count at 0 just before it
    _zero_counts()
    emb, preds = runner.encode_batch(images)
    torch.cuda.synchronize()
    launches = _read_counts()
    # ----
    _expect_counts("ViT-L/14@336px bf16", launches,
                   {"short_attention": model.config.vision_layers,
                    "short_attention.long_row_launches": model.config.vision_layers})
    uploaded = runner.upload_batch(images)
    imgs_per_s = _rate(lambda: runner.encode_batch_async(uploaded), 256, 3)
    del runner, model
    emb_plain, _ = ExtractionRunner(build(attn_impl="xla"), zs).encode_batch(images)
    cos = _cos_min(emb, emb_plain)
    row = {"phase": "vitl14_336_bf16", "model": "ViT-L/14@336px", "dtype": "bfloat16",
           "batch": 256, "image_hw": [218, 178], "launches": launches,
           "image_kernel_vs_plain_bf16_min_cosine": cos, "imgs_per_s_device": imgs_per_s}
    emit(row)
    if not (np.isfinite(emb).all() and emb.shape == (256, 768) and cos >= 0.999
            and preds.shape == (256,) and preds.min() >= 0 and preds.max() < 2):
        raise AssertionError(f"ViT-L/14@336px bf16 through kernel 1 disagrees: {row}")
    return {"vit_l14_336_bf16": launches}


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
    from chip_profile import kernel_breakdown
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
    from debiasing_multi_modal_tpu_torch.data.synthetic import (
        SyntheticSpec,
        make_synthetic_dataset,
    )
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig

    cfg = TrainConfig(**STAGE_B_FLAGS)
    data = make_synthetic_dataset(SyntheticSpec(**STAGE_B_SPEC, seed=SEED))
    card, _, launches, checks, ok, perf = _run_against_cpu("stage_b", cfg, data,
                                                           _stage_b_init(cfg))
    emit({"phase": "stage_b", "config": {**STAGE_B_FLAGS, "lr_decay_epochs": [90, 95]},
          "data": {**STAGE_B_SPEC, "seed": SEED}, "launches": launches, "perf": perf,
          "checks": checks})
    if not ok:
        raise AssertionError(f"Stage B on the card disagrees with the CPU: {checks}")

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


# The contrastive adapter: the notebook flow (TrainConfig defaults: 64
# positives, 64 negatives, batch_factor 4, temperature 0.1, weight 0.1,
# ca_pre_norm; ca_head="linear", a whole CE epoch after each SupCon epoch)
# on the Waterbirds-size D=1024 cache, 6 epochs.
CONTRASTIVE_FLAGS = dict(tl_method="contrastive_adapter", ca_head="linear", ca_ce_update=-1,
                         epochs=6, input_dim=1024, random_seed=42)


def _run_against_cpu(path, cfg, data, init):
    """``train_all_epochs`` on the card (every launch count at 0 just before
    it, read just after) and on the CPU from one ``init``, each
    checkpointing every epoch; the card held to the CPU within PERF.md §2's
    Stage-B limits.  Returns (card result, launches, checks, seconds)."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.train.checkpoint import load_checkpoint
    from debiasing_multi_modal_tpu_torch.train.loop import train_all_epochs

    bundles = {dev: _stage_b_bundle(data, dev) for dev in ("cuda", "cpu")}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = {dev: os.path.join(tmp, dev) for dev in ("cuda", "cpu")}
        kw = dict(verbose=False, init=init, checkpoint_every=1, checkpoint_keep=cfg.epochs)
        # ---- the main path, with every launch count at 0 just before it
        _zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        card = train_all_epochs(cfg, bundles["cuda"], checkpoint_dir=ckpt["cuda"],
                                device="cuda", **kw)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        launches = _read_counts()
        # ----
        _expect_counts(path, launches, {})
        t = time.perf_counter()
        cpu = train_all_epochs(cfg, bundles["cpu"], checkpoint_dir=ckpt["cpu"], device="cpu",
                               **kw)
        cpu_s = time.perf_counter() - t
        gaps = {}
        for epoch in (1, cfg.epochs):
            saved = {dev: load_checkpoint(os.path.join(ckpt[dev], f"ep{epoch:05d}"))
                     for dev in ckpt}
            assert saved["cuda"][0] == saved["cpu"][0] == epoch
            gaps[epoch] = _payload_gaps(saved["cuda"][1], saved["cpu"][1])
    acc_gap = max(abs(a[key] - b[key])
                  for split in ("train", "val", "test")
                  for a, b in zip(card[2][split], cpu[2][split]) for key in a)
    checks = {"epoch1_state_max_rel_gap": max(gaps[1].values()),
              "epoch1_state_worst_tensor": max(gaps[1], key=gaps[1].get),
              "final_state_max_rel_gap": max(gaps[cfg.epochs].values()),
              "final_state_worst_tensor": max(gaps[cfg.epochs], key=gaps[cfg.epochs].get),
              "final_state_tensors": len(gaps[cfg.epochs]),
              "per_epoch_acc_max_gap": acc_gap,
              "selected_test_worst_acc_gap": abs(card[0][2]["worst_acc"]
                                                 - cpu[0][2]["worst_acc"]),
              "card_best_test": card[0][2], "cpu_best_test": cpu[0][2],
              "card_zero_shot": card[1],
              "history_finite": all(np.isfinite(v) for split in ("train", "val", "test")
                                    for row in card[2][split] for v in row.values()),
              "epochs": len(card[2]["test"])}
    ok = (checks["history_finite"] and checks["epochs"] == cfg.epochs
          and checks["epoch1_state_max_rel_gap"] <= 1e-4
          and checks["final_state_max_rel_gap"] <= FINAL_STATE_LIMIT
          and acc_gap <= 5e-3 and checks["selected_test_worst_acc_gap"] <= 1e-2)
    return card, cpu, launches, checks, ok, {"card_run_s": card_s, "cpu_run_s": cpu_s}


def _contrastive_epoch_perf(cfg, bundle, init):
    """One contrastive epoch on the card (the rows' upload included) under
    the sync check: ms, steps, rows per second; launches per step and the
    idle share from the profiler over 32 steps."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.train import steps
    from debiasing_multi_modal_tpu_torch.train.contrastive import (
        train_contrastive_epoch,
        train_contrastive_epoch_vmapped,
    )
    from debiasing_multi_modal_tpu_torch.train.loop import (
        _tensors,
        contrastive_epoch_rows,
        contrastive_rows_and_counts,
        make_classifier,
        make_encoder,
    )
    from debiasing_multi_modal_tpu_torch.train.schedules import epoch_batch_lrs
    from chip_profile import kernel_breakdown
    from debiasing_multi_modal_tpu_torch.utils.staging import upload

    rng = np.random.default_rng(cfg.random_seed)
    (rows,), counts = contrastive_rows_and_counts(cfg, bundle, [rng])
    single = make_classifier(cfg)
    single.load_state_dict(_tensors(init["init_sd"]))
    encoder = make_encoder(cfg, single.adapter).cuda()
    encoder.head.load_state_dict(_tensors(init["ca_head_sd"], "head."))
    state = steps.init_train_state(encoder)
    mask = steps.ones_mask(state.params)
    epoch_rows = contrastive_epoch_rows(rows, rng, cfg.batch_factor)
    nb = len(epoch_rows)
    lrs = epoch_batch_lrs(cfg, 1, nb, 1)
    kw = dict(num_anchor=counts[0], num_positive=counts[1], num_negative=counts[2],
              temperature=cfg.cl_temperature, contrastive_weight=cfg.contrastive_weight,
              ca_pre_norm=cfg.ca_pre_norm, momentum=cfg.momentum,
              weight_decay=cfg.weight_decay)

    def epoch(n=None):
        return train_contrastive_epoch(state, bundle.train.emb,
                                       upload(epoch_rows[:n], bundle.train.emb.device),
                                       lrs[:n], mask, **kw)[1]

    epoch(8)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    with no_host_sync():
        losses = epoch()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    profile = kernel_breakdown(lambda: epoch(32), reps=1, top=6)
    rows_per_step = cfg.batch_factor * sum(counts)

    # the stacked form (the sweep's), three rows of one epoch's steps, under
    # the same sync check
    stacked = steps.StackedState.stack([encoder] * 3, "cuda")
    stacked_rows = upload(np.stack([epoch_rows] * 3), bundle.train.emb.device)
    stacked_lrs = upload(np.stack([lrs] * 3), bundle.train.emb.device)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with no_host_sync():
        stacked_losses = train_contrastive_epoch_vmapped(
            stacked, bundle.train.emb, stacked_rows, stacked_lrs,
            steps.ones_mask(stacked.params), **kw)[1]
    torch.cuda.synchronize()
    stacked_ms = (time.perf_counter() - t) * 1e3
    return {"steps": nb, "rows_per_step": rows_per_step, "counts": list(counts),
            "stacked_3_rows_epoch_ms": stacked_ms,
            "stacked_losses_finite": bool(torch.isfinite(stacked_losses).all().item()),
            "anchor_rows": len(rows), "epoch_ms_host_clock": host_ms,
            "step_ms": host_ms / nb, "rows_per_s": nb * rows_per_step / host_ms * 1e3,
            "launches_per_step": profile["kernel_launches_per_call"] / 32,
            "idle_share_32_steps": profile["idle_share"],
            "device_busy_ms_per_step": profile["device_busy_ms_per_call"] / 32,
            "top_kernels_32_steps": profile["top_kernels_ms_per_call"],
            "losses_finite": bool(torch.isfinite(losses).all().item())}


def phase_contrastive():
    """The contrastive adapter on the card against the CPU, and one timed
    contrastive epoch; returns the path's launch counts (no kernel of the
    port runs there: the JAX package's Stage B is XLA only)."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.data.synthetic import (
        SyntheticSpec,
        make_synthetic_dataset,
    )
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
    from debiasing_multi_modal_tpu_torch.train.loop import make_classifier, make_encoder

    cfg = TrainConfig(**CONTRASTIVE_FLAGS)
    data = make_synthetic_dataset(SyntheticSpec(**STAGE_B_SPEC, seed=SEED))
    table = data[1]
    train = table.split == 0
    anchors = int((table.y[train] != table.y_pred[train]).sum())
    gen = torch.Generator().manual_seed(cfg.random_seed)
    single = make_classifier(cfg, gen)
    head = make_encoder(cfg, single.adapter, gen).head
    init = {"init_sd": single.state_dict(),
            "ca_head_sd": {f"head.{k}": v for k, v in head.state_dict().items()}}
    card, cpu, launches, checks, ok, perf = _run_against_cpu("contrastive", cfg, data, init)
    checks["cl_loss_card"] = card[2]["cl_loss"]
    checks["cl_loss_max_rel_gap"] = max(abs(a - b) / abs(b) for a, b in
                                        zip(card[2]["cl_loss"], cpu[2]["cl_loss"]))
    emit({"phase": "contrastive", "config": CONTRASTIVE_FLAGS,
          "data": {**STAGE_B_SPEC, "seed": SEED, "zero_shot_mistakes": anchors},
          "launches": launches, "perf": perf, "checks": checks})
    if not (ok and np.isfinite(card[2]["cl_loss"]).all()):
        raise AssertionError(f"the contrastive adapter on the card disagrees with the CPU: "
                             f"{checks}")
    bundle = _stage_b_bundle(data, "cuda")
    epoch = _contrastive_epoch_perf(cfg, bundle, init)
    emit({"phase": "contrastive", "epoch": epoch})
    if not (epoch["losses_finite"] and epoch["stacked_losses_finite"]):
        raise AssertionError(f"contrastive epoch: {epoch}")
    return {"contrastive": launches}


# The user's Waterbirds grid (scripts/run_sweep_wb.sh): 2 lr x 2 bs x 4 bsr
# cells x 3 seeds = 48 rows stacked into one program, epochs cut to 6 with
# the phase switch after 3; and its CelebA grid (scripts/run_sweep_ca.sh) at
# CelebA scale, 3 bsr cells x 2 seeds = 6 rows.
SWEEP_WB = dict(base=dict(tl_method="adapter_reg_seq_alter", add_adapter=True, warm_reg=True,
                          lr_decay_rate=0.1, lr_decay_epochs=(90, 95), epochs=6,
                          epochs_feature_learning=3, input_dim=1024, dataset="waterbirds"),
                seeds=[42, 32, 22], lr_list=[1.0, 10.0], bs_list=[512, 1024],
                bsr_list=[64, 128, 256, 512], lr_multiple=1.0)
SWEEP_WB_CHECKED = ((1.0, 512, 64, 42), (10.0, 1024, 512, 42), (10.0, 512, 128, 32))
SWEEP_CA = dict(lr=0.1, lr_multiple=10.0, bs=1024, bsr_list=[4, 8, 16], seeds=[42, 32])
PROFILED_STEPS = 32


def _stacked_profile(state, emb, labels, groups, plans, lrs, text, mask_tree, steps_wanted):
    """Profile ``steps_wanted`` stacked steps at the plans' shapes (the
    epoch's steps repeated): launches per step, idle share, busy ms/step."""
    import numpy as np

    from debiasing_multi_modal_tpu_torch.sweep.vmap_loop import _pad_stack_plans
    from debiasing_multi_modal_tpu_torch.train import steps
    from chip_profile import kernel_breakdown
    from debiasing_multi_modal_tpu_torch.utils.staging import upload

    idx, msk, act = _pad_stack_plans(plans)
    reps = -(-steps_wanted // idx.shape[1])
    idx, msk, act, lrs = (upload(np.concatenate([a] * reps, axis=1)[:, :steps_wanted],
                                 emb.device) for a in (idx, msk, act, lrs))

    def run():
        steps.train_epoch_vmapped(state, emb, labels, groups, idx, msk, lrs, text, mask_tree,
                                  active=act)

    profile = kernel_breakdown(run, reps=1, top=8)
    return {"steps": steps_wanted,
            "launches_per_step": profile["kernel_launches_per_call"] / steps_wanted,
            "idle_share": profile["idle_share"],
            "device_busy_ms_per_step": profile["device_busy_ms_per_call"] / steps_wanted,
            "wall_ms_per_step": profile["wall_ms_per_call"] / steps_wanted,
            "top_kernels": profile["top_kernels_ms_per_call"]}


def _stacked_epoch(state, emb, labels, groups, plans, lrs, text, mask_tree):
    """One stacked epoch on the card under the sync check (the plan's upload
    included): ms by the host clock, steps."""
    import torch

    from debiasing_multi_modal_tpu_torch.sweep.vmap_loop import _pad_stack_plans
    from debiasing_multi_modal_tpu_torch.train import steps
    from debiasing_multi_modal_tpu_torch.utils.staging import upload

    idx, msk, act = _pad_stack_plans(plans)
    dev = emb.device
    torch.cuda.synchronize()
    t = time.perf_counter()
    with no_host_sync():
        _, stats = steps.train_epoch_vmapped(
            state, emb, labels, groups, upload(idx, dev), upload(msk, dev), upload(lrs, dev),
            text, mask_tree, active=None if act.all() else upload(act, dev))
    torch.cuda.synchronize()
    return {"rows": idx.shape[0], "steps": idx.shape[1], "batch_max": idx.shape[2],
            "epoch_ms_host_clock": (time.perf_counter() - t) * 1e3,
            "counts_exact": bool((stats.counts.sum(-1).cpu() == torch.tensor(
                [float(p.mask.sum()) for p in plans])).all())}


def _sweep_stacked_steps(data):
    """The Waterbirds grid's stacked steps at its shapes, timed and profiled:
    a phase-1 epoch (48 adapters, bs 512/1024 padded to 1024) and a phase-2
    reg epoch (48 multiple adapters, bsr 64..512 padded)."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.data.samplers import (
        epoch_plan,
        stratified_split_indices,
    )
    from debiasing_multi_modal_tpu_torch.train import steps
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
    from debiasing_multi_modal_tpu_torch.train.loop import (
        make_classifier,
        make_multiple_classifier,
    )
    from debiasing_multi_modal_tpu_torch.train.schedules import epoch_batch_lrs
    from debiasing_multi_modal_tpu_torch.utils.staging import upload

    bundle = _stage_b_bundle(data, "cuda")
    base = TrainConfig(**SWEEP_WB["base"])
    rows = [(lr, bs, bsr, seed) for bs in SWEEP_WB["bs_list"] for bsr in SWEEP_WB["bsr_list"]
            for lr in SWEEP_WB["lr_list"] for seed in SWEEP_WB["seeds"]]
    rng = np.random.default_rng(SEED)
    out = {}
    reg_idx, _ = stratified_split_indices(bundle.val.group, 0.5, seed=42)
    reg = bundle.val.take(reg_idx)
    for phase, split, make, key in (
            (1, bundle.train, make_classifier, 1),
            (2, reg, make_multiple_classifier, 2)):
        modules = [make(base, torch.Generator().manual_seed(seed)) for *_, seed in rows]
        state = steps.StackedState.stack(modules, "cuda", base.zs_temperature)
        mask_tree = (steps.freeze_subtrees(state.params, ("old_cls",)) if phase == 2
                     else steps.ones_mask(state.params))
        plans = [epoch_plan(len(split), bs if phase == 1 else bsr, True, rng)
                 for _, bs, bsr, _ in rows]
        nb = max(p.num_batches for p in plans)
        lrs = np.zeros((len(rows), nb), np.float32)
        for i, ((lr, *_), p) in enumerate(zip(rows, plans)):
            cell = base.replace(learning_rate=lr, learning_rate_reg=lr)
            lrs[i, :p.num_batches] = epoch_batch_lrs(cell, 4 if phase == 2 else 1,
                                                     p.num_batches, phase)
        dev = bundle.train.emb.device
        # phase 2 on an even epoch: the group prompts, the group labels
        labels = upload((split.group if phase == 2 else split.y).astype(np.int64), dev)
        groups = upload(split.group.astype(np.int64), dev)
        text = upload(bundle.text_group if phase == 2 else bundle.text_class, dev)
        _stacked_epoch(state, split.emb, labels, groups, plans, lrs, text, mask_tree)  # warm
        timed = _stacked_epoch(state, split.emb, labels, groups, plans, lrs, text, mask_tree)
        timed["profile"] = _stacked_profile(state, split.emb, labels, groups, plans, lrs,
                                            text, mask_tree, PROFILED_STEPS)
        out[f"phase{key}"] = timed
    return out


def _celeba_sweep_epochs():
    """The CelebA grid's stacked epochs at CelebA scale (162,770 x 1024
    rows on the card, 667 MB, shared by every row): one phase-1 epoch of the
    6 adapters (bs 1024, 159 steps) and one reg epoch of the 6 multiple
    adapters over the 9,933-row reg half (bsr 4 / 8 / 16, the bsr-4 rows
    set its length; the shorter rows no-op through their padded tail), each
    under the sync check."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.data.samplers import epoch_plan
    from debiasing_multi_modal_tpu_torch.train import steps
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
    from debiasing_multi_modal_tpu_torch.train.loop import (
        make_classifier,
        make_multiple_classifier,
    )
    from debiasing_multi_modal_tpu_torch.train.schedules import epoch_batch_lrs

    n, d = CELEBA_TRAIN_ROWS, 1024
    reg_rows = CELEBA_VAL_ROWS // 2
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    emb = torch.randn(n, d, device="cuda", generator=gen)
    y = torch.randint(0, 2, (n,), device="cuda", generator=gen)
    groups = y * 2 + torch.randint(0, 2, (n,), device="cuda", generator=gen)
    text_class = torch.randn(d, 2, device="cuda", generator=gen)
    text_group = torch.randn(d, 4, device="cuda", generator=gen)
    base = TrainConfig(tl_method="adapter_reg_seq_alter", add_adapter=True, warm_reg=True,
                       dataset="celeba", input_dim=d, epochs=65, epochs_feature_learning=40,
                       learning_rate=SWEEP_CA["lr"],
                       learning_rate_reg=SWEEP_CA["lr"] * SWEEP_CA["lr_multiple"],
                       batch_size=SWEEP_CA["bs"])
    rows = [(bsr, seed) for bsr in SWEEP_CA["bsr_list"] for seed in SWEEP_CA["seeds"]]
    rng = np.random.default_rng(SEED)
    out = {"train_rows": n, "reg_rows": reg_rows, "dim": d,
           "table_mb": emb.numel() * 4 / 1e6}
    for phase, make in ((1, make_classifier), (2, make_multiple_classifier)):
        state = steps.StackedState.stack(
            [make(base, torch.Generator().manual_seed(seed)) for _, seed in rows], "cuda",
            base.zs_temperature)
        mask_tree = (steps.freeze_subtrees(state.params, ("old_cls",)) if phase == 2
                     else steps.ones_mask(state.params))
        plans = [epoch_plan(n if phase == 1 else reg_rows, base.batch_size if phase == 1
                            else bsr, True, rng) for bsr, _ in rows]
        nb = max(p.num_batches for p in plans)
        lrs = np.zeros((len(rows), nb), np.float32)
        for i, p in enumerate(plans):
            lrs[i, :p.num_batches] = epoch_batch_lrs(base, 1 if phase == 1 else 41,
                                                     p.num_batches, phase)
        labels = y if phase == 1 else groups
        text = text_class if phase == 1 else text_group
        cut = None
        if phase == 2 and nb > 512:
            # time the first 512 steps only when the whole epoch would take
            # more than 30 s at the warm-up's rate
            warm = [_first_steps(p, 16) for p in plans]
            w = _stacked_epoch(state, emb, labels, groups, warm, lrs[:, :16], text, mask_tree)
            if w["epoch_ms_host_clock"] / 16 * nb > 30e3:
                cut = 512
        else:
            _stacked_epoch(state, emb, labels, groups, [_first_steps(p, 16) for p in plans],
                           lrs[:, :16], text, mask_tree)
        timed_plans = plans if cut is None else [_first_steps(p, cut) for p in plans]
        timed = _stacked_epoch(state, emb, labels, groups, timed_plans,
                               lrs if cut is None else lrs[:, :cut], text, mask_tree)
        timed["epoch_steps"] = nb
        timed["timed_steps_only"] = cut
        timed["step_ms"] = timed["epoch_ms_host_clock"] / timed["steps"]
        timed["per_row_steps"] = [p.num_batches for p in plans]
        timed["rows_per_s"] = (sum(int(p.mask[:cut].sum()) for p in plans)
                               / timed["epoch_ms_host_clock"] * 1e3)
        out[f"phase{phase}"] = timed
    del emb
    return out


def _first_steps(plan, steps_):
    """The first ``steps_`` batches of a BatchPlan."""
    import dataclasses

    return dataclasses.replace(plan, indices=plan.indices[:steps_], mask=plan.mask[:steps_])


def _sweep_cli():
    """cli/sweep_main.py --device cuda once on a small cache: 2 lr x 2 bsr
    cells, 2 seeds, stacked; one CSV per cell."""
    import io

    from debiasing_multi_modal_tpu_torch.cli import sweep_main
    from debiasing_multi_modal_tpu_torch.data.synthetic import (
        SyntheticSpec,
        make_synthetic_dataset,
    )

    data = make_synthetic_dataset(SyntheticSpec(dim=1024, n_train=1024, n_val=512,
                                                n_test=512, seed=SEED))
    with tempfile.TemporaryDirectory() as tmp:
        _write_stage_b_caches(data, tmp)
        args = sweep_main.extend_parser(sweep_main.build_parser()).parse_args([
            "--dataset", "waterbirds", "--data_dir", tmp,
            "--image_embedding_dir", os.path.join(tmp, "RN50", "clip.npz"),
            "--text_embedding_dir", os.path.join(tmp, "clip_class.json"),
            "--text_spurious_embedding_dir", os.path.join(tmp, "clip_spurious.json"),
            "--text_group_embedding_dir", os.path.join(tmp, "clip_group.json"),
            "--tl_method", "adapter_reg_seq_alter", "--add_adapter", "--warm_reg",
            "--epochs", "4", "--epochs_feature_learning", "2", "--batch_size", "256",
            "--lr_list", "1,10", "--bsr_list", "64,128", "--lr_multiple", "1.0",
            "--num_iter", "2", "--random_seeds", "42,32", "--stack_lr_axis",
            "--stack_bsr_axis", "--result_root", os.path.join(tmp, "results"),
            "--device", "cuda"])
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = sweep_main.main(args)
        seconds = time.perf_counter() - t
        csvs = sorted(os.listdir(os.path.join(tmp, "results")))
    return {"rc": rc, "seconds": seconds, "cells": 4, "csv_files": csvs,
            "wrote_lines": sum(line.startswith("wrote ") for line in out.getvalue().splitlines())}


def phase_sweep():
    """The stacked sweep on the card: the Waterbirds grid as one program,
    three of its rows against their sequential runs, its stacked steps
    profiled, the CelebA grid's stacked epochs, and sweep_main; returns the
    path's launch counts (no kernel of the port runs there)."""
    import torch

    from debiasing_multi_modal_tpu_torch.data.synthetic import (
        SyntheticSpec,
        make_synthetic_dataset,
    )
    from debiasing_multi_modal_tpu_torch.sweep.runner import cell_filename, run_sweep
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
    from debiasing_multi_modal_tpu_torch.train.loop import train_all_epochs

    data = make_synthetic_dataset(SyntheticSpec(**STAGE_B_SPEC, seed=SEED))
    bundle = _stage_b_bundle(data, "cuda")
    base = TrainConfig(**SWEEP_WB["base"])
    grid = {k: SWEEP_WB[k] for k in ("lr_list", "bs_list", "bsr_list", "lr_multiple")}
    with tempfile.TemporaryDirectory() as tmp:
        # ---- the main path, with every launch count at 0 just before it
        _zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        stacked = run_sweep(base, bundle, SWEEP_WB["seeds"], **grid, stack_lr_axis=True,
                            stack_bsr_axis=True, stack_bs_axis=True, result_root=tmp,
                            device="cuda")
        torch.cuda.synchronize()
        stacked_s = time.perf_counter() - t
        launches = _read_counts()
        # ----
        csvs = len(os.listdir(tmp))
    _expect_counts("sweep", launches, {})
    # the same grid again, warm (the first run pays the allocator's growth
    # and the libraries' first calls), under the profiler: the whole
    # program's device busy time and idle share
    from chip_profile import kernel_breakdown

    with tempfile.TemporaryDirectory() as tmp:
        warm = kernel_breakdown(
            lambda: run_sweep(base, bundle, SWEEP_WB["seeds"], **grid, stack_lr_axis=True,
                              stack_bsr_axis=True, stack_bs_axis=True, result_root=tmp,
                              device="cuda"), reps=1, top=6)
    by_name = {os.path.basename(path): results for path, results in stacked.items()}
    rows, seq_s, gaps = [], [], []
    for lr, bs, bsr, seed in SWEEP_WB_CHECKED:
        cell = base.replace(learning_rate=lr, learning_rate_reg=lr * SWEEP_WB["lr_multiple"],
                            batch_size=bs, batch_size_reg=bsr)
        row = by_name[cell_filename(cell)][SWEEP_WB["seeds"].index(seed)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        seq = train_all_epochs(cell.replace(random_seed=seed), bundle, verbose=False,
                               device="cuda")
        torch.cuda.synchronize()
        seq_s.append(time.perf_counter() - t)
        names = ("train", "val", "test", "zs_class", "zs_spurious")
        dict_gaps = {name: max(abs(a[k] - b[k]) for k in a)
                     for name, a, b in zip(names, row[0] + row[1], seq[0] + seq[1])}
        worst = abs(row[0][2]["worst_acc"] - seq[0][2]["worst_acc"])
        gaps.append((dict_gaps, worst))
        rows.append({"lr": lr, "bs": bs, "bsr": bsr, "seed": seed, "stacked_best_test": row[0][2],
                     "sequential_best_test": seq[0][2], "dict_gaps": dict_gaps,
                     "selected_test_worst_acc_gap": worst})
    n_rows = sum(len(r) for r in stacked.values())
    emit({"phase": "sweep", "grid": "scripts/run_sweep_wb.sh", "rows": n_rows, "cells": csvs,
          "config": {**SWEEP_WB["base"], "lr_decay_epochs": [90, 95]},
          "launches": launches,
          "perf": {"stacked_wall_s": stacked_s, "stacked_ms_per_epoch": stacked_s * 1e3
                   / base.epochs, "warm_stacked_wall_s": warm["wall_ms_per_call"] / 1e3,
                   "warm_device_busy_s": warm["device_busy_ms_per_call"] / 1e3,
                   "warm_idle_share": warm["idle_share"],
                   "warm_launches": warm["kernel_launches_per_call"],
                   "warm_top_kernels": warm["top_kernels_ms_per_call"],
                   "sequential_rows_s": seq_s,
                   "sequential_estimate_of_grid_s": sum(seq_s) * n_rows / len(seq_s)},
          "checked_rows": rows})
    # the test split's dicts (5,794 rows, ~1,450 a group) within 5e-3; the
    # train and val dicts come from the 600-row reg and val halves, where one
    # flipped prediction in a ~150-row group moves an accuracy by ~6.7e-3, so
    # they are held to the 1e-2 the selected worst-group accuracy takes
    if not (n_rows == 48 and csvs == 16
            and all(g["train"] <= 1e-2 and g["val"] <= 1e-2
                    and max(g["test"], g["zs_class"], g["zs_spurious"]) <= 5e-3 and w <= 1e-2
                    for g, w in gaps)):
        raise AssertionError(f"the stacked grid disagrees with its sequential rows: {rows}")
    steps_perf = _sweep_stacked_steps(data)
    emit({"phase": "sweep", "stacked_steps": steps_perf})
    del bundle
    celeba = _celeba_sweep_epochs()
    emit({"phase": "sweep", "grid": "scripts/run_sweep_ca.sh", "celeba_scale": celeba})
    cli = _sweep_cli()
    emit({"phase": "sweep", "cli": cli})
    if not (all(v["counts_exact"] for v in steps_perf.values())
            and celeba["phase1"]["counts_exact"] and celeba["phase2"]["counts_exact"]
            and cli["rc"] == 0 and len(cli["csv_files"]) == cli["cells"] == cli["wrote_lines"]):
        raise AssertionError(f"sweep: {steps_perf} {celeba} {cli}")
    return {"sweep": launches}

# ------------------------------------------------------------ native JSON --


def phase_native_json():
    """The native clip.json parser on a Waterbirds-size cache; returns the
    path's launch counts (no kernel runs there)."""
    import io

    import numpy as np

    from debiasing_multi_modal_tpu_torch.cli import train_main
    from debiasing_multi_modal_tpu_torch.data import embeddings_store as store
    from debiasing_multi_modal_tpu_torch.data.synthetic import (
        SyntheticSpec,
        make_synthetic_dataset,
    )
    from debiasing_multi_modal_tpu_torch.native import ebdjson
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig

    t = time.perf_counter()
    library = ebdjson.build()  # raises if g++ or the source is missing
    build_s = time.perf_counter() - t
    data = make_synthetic_dataset(SyntheticSpec(**STAGE_B_SPEC, seed=SEED))
    table = data[1]
    cfg = TrainConfig(**STAGE_B_FLAGS)
    python_before = (store._load_json_python.calls, store._save_json_python.calls)
    _zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "RN50", "clip.json")
        t = time.perf_counter()
        store.save_embeddings(path, table, fmt="json", dataset="waterbirds")
        write_s = time.perf_counter() - t
        native_before = ebdjson.load_embeddings_json.calls
        t = time.perf_counter()
        native = store.load_embeddings(path, dataset="waterbirds")
        native_s = time.perf_counter() - t
        if ebdjson.load_embeddings_json.calls != native_before + 1:
            raise AssertionError("the store did not load clip.json with the native parser")
        if (store._load_json_python.calls, store._save_json_python.calls) != python_before:
            raise AssertionError("the Python JSON parser or writer ran")
        t = time.perf_counter()
        python = store._load_json_python(path, "waterbirds")
        python_s = time.perf_counter() - t
        for col in ("filenames", "y", "place", "group", "split", "y_pred"):
            np.testing.assert_array_equal(getattr(native, col), getattr(python, col))
        np.testing.assert_allclose(native.embeddings, python.embeddings, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(native.embeddings, table.embeddings, rtol=1e-6, atol=1e-7)
        file_mb = os.path.getsize(path) / 1e6
        python_before = (store._load_json_python.calls, store._save_json_python.calls)
        _write_stage_b_caches(data, tmp)
        best = {}
        for fmt in ("json", "npz"):
            args = train_main.build_parser().parse_args([
                "--dataset", "waterbirds", "--data_dir", tmp,
                "--image_embedding_dir", os.path.join(tmp, "RN50", f"clip.{fmt}"),
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
                "--random_seed", str(cfg.random_seed), "--device", "cuda"])
            out = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = train_main.main(args)
            best[fmt] = {"rc": rc, "seconds": time.perf_counter() - t,
                         "best_test": next(line for line in out.getvalue().splitlines()
                                           if line.startswith("best test:"))}
        if (store._load_json_python.calls, store._save_json_python.calls) != python_before:
            raise AssertionError("the Python JSON parser or writer ran")
    launches = _read_counts()
    _expect_counts("native_json", launches, {})
    emit({"phase": "native_json", "library": os.path.relpath(library), "build_s": build_s,
          "rows": len(table), "dim": int(table.embeddings.shape[1]), "file_mb": file_mb,
          "write_native_s": write_s, "load_native_s": native_s, "load_python_s": python_s,
          "native_loads": ebdjson.load_embeddings_json.calls, "train_main": best})
    if not (best["json"]["rc"] == best["npz"]["rc"] == 0
            and best["json"]["best_test"] == best["npz"]["best_test"]):
        raise AssertionError(f"train_main from clip.json differs from clip.npz: {best}")
    return {"native_json": launches}


# ------------------------------------------------------------- parallelism --


def _timed(fn):
    """(result, host seconds) of ``fn``, the card synchronized at both ends."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _parallel_extraction(mesh, data_mesh):
    """ViT-B/32 at full width, batch 256: the unsharded runner, the
    data-parallel and the tensor-parallel (tp = 1) paths, each with the
    counts at 0 just before its batch and read just after."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.extract.runner import ExtractionRunner
    from debiasing_multi_modal_tpu_torch.models import create_clip

    model = create_clip("ViT-B/32", dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 7)
    images = rng.integers(0, 256, (256, 256, 256, 3), dtype=np.uint8)
    zs = rng.standard_normal((2, 512)).astype(np.float32)
    want = {"short_attention": model.config.vision_layers}
    out, launches = {}, {}
    for name, kw in (("unsharded", {}), ("parallel_dp", {"mesh": data_mesh}),
                     ("parallel_tp", {"mesh": mesh, "tensor_parallel": True})):
        runner = ExtractionRunner(model, zs, **kw)
        runner.encode_batch(images)  # warm
        _zero_counts()
        (emb, preds), _ = _timed(lambda: runner.encode_batch(images))
        launches[name] = _read_counts()
        _expect_counts(name, launches[name], want)
        _, seconds = _timed(lambda: [runner.encode_batch(images) for _ in range(5)])
        out[name] = {"emb": emb, "preds": preds, "imgs_per_s": 5 * 256 / seconds}
    ref = out.pop("unsharded")
    rows = {"unsharded_imgs_per_s": ref["imgs_per_s"]}
    for name, got in out.items():
        rows[name] = {"imgs_per_s": got["imgs_per_s"],
                      "bit_equal": bool(np.array_equal(got["emb"], ref["emb"])),
                      "max_rel_err": _rel(got["emb"], ref["emb"]),
                      "cos_min": _cos_min(got["emb"], ref["emb"]),
                      "preds_equal_share": float((got["preds"] == ref["preds"]).mean())}
        if not (rows[name]["cos_min"] >= 0.999 and rows[name]["preds_equal_share"] >= 0.99):
            raise AssertionError(f"{name} extraction disagrees with the unsharded runner: "
                                 f"{rows[name]}")
    if not rows["parallel_dp"]["bit_equal"]:
        raise AssertionError("data-parallel extraction on one rank is not the unsharded one")
    launches.pop("unsharded")
    return rows, launches


def _parallel_stage_b(data_mesh):
    """The flagship Stage-B run through shard_bundle against the unsharded
    run, and the 48-row Waterbirds grid with the seed mesh against the
    unsharded grid (both on the card, every kernel count staying 0)."""
    from debiasing_multi_modal_tpu_torch.data.synthetic import (
        SyntheticSpec,
        make_synthetic_dataset,
    )
    from debiasing_multi_modal_tpu_torch.sweep.runner import run_sweep
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
    from debiasing_multi_modal_tpu_torch.train.loop import shard_bundle, train_all_epochs

    data = make_synthetic_dataset(SyntheticSpec(**STAGE_B_SPEC, seed=SEED))
    bundle = _stage_b_bundle(data, "cuda")
    cfg = TrainConfig(**STAGE_B_FLAGS)
    init = _stage_b_init(cfg)
    _zero_counts()
    sharded = shard_bundle(bundle, data_mesh)
    runs = {"unsharded": [], "shard_bundle": []}
    # in turns (unsharded, sharded, sharded, unsharded): the first run of a
    # process pays the libraries' first calls
    for name, b in (("unsharded", bundle), ("shard_bundle", sharded),
                    ("shard_bundle", sharded), ("unsharded", bundle)):
        res, seconds = _timed(lambda: train_all_epochs(cfg, b, verbose=False, init=init,
                                                       device="cuda"))
        runs[name].append((res[:2], seconds))
    results = [r for rows in runs.values() for r, _ in rows]
    out = {"stage_b": {"unsharded_s": [t for _, t in runs["unsharded"]],
                       "shard_bundle_s": [t for _, t in runs["shard_bundle"]],
                       "results_equal": all(r == results[0] for r in results)}}
    base = TrainConfig(**SWEEP_WB["base"])
    grid = {k: SWEEP_WB[k] for k in ("lr_list", "bs_list", "bsr_list", "lr_multiple")}
    csvs = {"unsharded": [], "seed_mesh": []}
    for name, mesh in (("unsharded", None), ("seed_mesh", data_mesh),
                       ("seed_mesh", data_mesh), ("unsharded", None)):
        with tempfile.TemporaryDirectory() as tmp:
            _, seconds = _timed(lambda: run_sweep(
                base, bundle, SWEEP_WB["seeds"], **grid, stack_lr_axis=True,
                stack_bsr_axis=True, stack_bs_axis=True, result_root=tmp, mesh=mesh,
                device="cuda"))
            files = {}
            for f in sorted(os.listdir(tmp)):
                with open(os.path.join(tmp, f)) as fh:
                    files[f] = fh.read()
            csvs[name].append((files, seconds))
    every = [files for rows in csvs.values() for files, _ in rows]
    out["sweep"] = {"rows": 48, "cells": len(every[0]),
                    "unsharded_s": [t for _, t in csvs["unsharded"]],
                    "seed_mesh_s": [t for _, t in csvs["seed_mesh"]],
                    "csvs_identical": all(files == every[0] for files in every)}
    launches = _read_counts()
    _expect_counts("parallel stage_b", launches, {})
    if not (out["stage_b"]["results_equal"] and out["sweep"]["csvs_identical"]):
        raise AssertionError(f"sharded Stage B differs from the unsharded run: {out}")
    return out


def _parallel_attention(data_mesh):
    """Ring and Ulysses attention on one rank at B=4 S=4096 H=16 hd=64 bf16
    against plain attention (the port's _xla_attention: bf16 logits) and an
    f32 reference on the same inputs, errors at the reference's scale."""
    import torch

    from debiasing_multi_modal_tpu_torch.ops.attention import _xla_attention
    from debiasing_multi_modal_tpu_torch.ops.ring_attention import sequence_parallel_attention
    from debiasing_multi_modal_tpu_torch.ops.ulysses_attention import (
        ulysses_sequence_parallel_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    q, k, v = (torch.randn(4, 4096, 16, 64, device="cuda", generator=gen, dtype=torch.bfloat16)
               for _ in range(3))
    out = {}
    for causal in (False, True):
        plain, plain_s = _timed(lambda: _xla_attention(q, k, v, causal=causal))
        ref32 = _xla_attention(q.float(), k.float(), v.float(), causal=causal)
        scale = ref32.abs().max().item()
        for name, fn in (("ring", sequence_parallel_attention),
                         ("ulysses", ulysses_sequence_parallel_attention)):
            got, seconds = _timed(lambda: fn(q, k, v, mesh=data_mesh, axis_name="data",
                                             causal=causal))
            row = {"s": seconds, "plain_s": plain_s,
                   "err_vs_plain": (got.float() - plain.float()).abs().max().item() / scale,
                   "err_vs_f32": (got.float() - ref32).abs().max().item() / scale,
                   "bit_equal_plain": bool(torch.equal(got, plain))}
            out[f"{name}_{'causal' if causal else 'full'}"] = row
            if not (row["err_vs_plain"] <= 2e-2 and row["err_vs_f32"] <= 2e-2):
                raise AssertionError(f"{name} attention disagrees with plain: {row}")
            del got
        del plain, ref32
        torch.cuda.empty_cache()
    return out


def _shard_shape_cases(gen):
    """Kernel 1 at the tp = 2 and 4 shard shapes of ViT-B/32 (image B=256
    S=50, text B=256 S=77 causal), kernel 7 at the shards' Dense shapes
    (M = 12,800 image tokens: c_fc and q/k/v column-parallel at N / tp,
    c_proj and out_proj row-parallel at K / tp)."""
    import torch

    from debiasing_multi_modal_tpu_torch.ops import short_attention as sa

    bf16 = torch.bfloat16
    attention, int8 = [], []
    for tp in (2, 4):
        for label, b, s, d, h, causal in (("image", 256, 50, 768, 12, False),
                                          ("text", 256, 77, 512, 8, True)):
            attention.append(_attention_case(
                sa.short_attention, sa.short_attention_reference,
                f"vitb32_{label}_tp{tp}_bf16", b, s, d // tp, h // tp, causal, bf16, 2e-2,
                gen, True))
        for label, k, n in (("c_fc", 768, 3072 // tp), ("qkv", 768, 768 // tp),
                            ("c_proj", 3072 // tp, 768), ("out_proj", 768 // tp, 768)):
            int8.append(_int8_case(f"vitb32_{label}_tp{tp}_bf16", 12800, k, n,
                                   label in ("c_fc", "qkv"), bf16, gen, True))
    return {"short_attention": attention, "int8_matmul": int8}


def _cos_flat(a, b):
    import torch.nn.functional as F

    return F.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0).item()


def _pipelined_encodes(mesh):
    """The RN50 text tower and the ViT-B/32 image tower pipelined (bf16, 4
    microbatches) against the same model's unpipelined encode, each with the
    counts at 0 just before it and read just after; the ViT encode again
    under the sync check and through the manual tp/sp block."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.models import create_clip
    from debiasing_multi_modal_tpu_torch.parallel import pp

    rng = np.random.default_rng(SEED + 11)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    kw = dict(mesh=mesh, microbatches=4, batch_axis="data")
    rows, launches = {}, {}
    for name, backbone in (("pipeline_rn50_text", "RN50"), ("pipeline_vitb32_image", "ViT-B/32")):
        model = create_clip(backbone, dtype=torch.bfloat16, device="cuda",
                            generator=torch.Generator().manual_seed(SEED))
        if name.endswith("text"):
            inputs = torch.from_numpy(_tokens(256, rng)).cuda()
            tower, piped = model.transformer, pp.pipelined_text_encode
            unpiped = model.encode_text
        else:
            inputs = torch.randn(256, 224, 224, 3, device="cuda", generator=gen)
            tower, piped = model.visual.transformer, pp.pipelined_vit_encode
            unpiped = model.encode_image
        with torch.no_grad():
            stacked, n_layers = pp.stack_block_params(tower)
            ref = unpiped(inputs)
            piped(model, None, inputs, stacked=stacked, **kw)  # warm
            _zero_counts()
            out = piped(model, None, inputs, stacked=stacked, **kw)
            torch.cuda.synchronize()
            launches[name] = _read_counts()
            _expect_counts(name, launches[name], {"short_attention": n_layers * 4})
            row = {"layers": n_layers, "microbatches": 4, "items": 256,
                   "cos_min": _cos_min(out, ref), "cos": _cos_flat(out, ref),
                   "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                   "scale": ref.float().abs().max().item(),
                   "per_s": _rate(lambda: piped(model, None, inputs, stacked=stacked, **kw),
                                  256, 5),
                   "unpipelined_per_s": _rate(lambda: unpiped(inputs), 256, 5)}
            if name.endswith("image"):
                with no_host_sync():
                    again = piped(model, None, inputs, stacked=stacked, **kw)
                torch.cuda.synchronize()
                row["sync_checked_equal"] = bool(torch.equal(again, out))
                local = pp.shard_stage_params(stacked, mesh, model_axis="model")
                manual = piped(model, None, inputs, stacked=local, model_axis="model",
                               seq_axis="seq", **kw)
                row["manual_block"] = {"cos_min": _cos_min(manual, ref),
                                       "max_abs_err": (manual.float() - ref.float()).abs()
                                       .max().item()}
                if row["manual_block"]["cos_min"] < 0.999:
                    raise AssertionError(f"the manual tp/sp block disagrees: {row}")
        rows[name] = row
        if row["cos_min"] < 0.999:
            raise AssertionError(f"{name} disagrees with the unpipelined encode: {row}")
        del model, ref, out
        torch.cuda.empty_cache()
    return rows, launches


def _pipelined_gradients(mesh):
    """One loss through pipeline_transformer (the ViT-B/32 image tower on
    128 images, bf16, 4 microbatches) with remat off and on, against the
    unpipelined tower's gradients."""
    import torch

    from debiasing_multi_modal_tpu_torch.models import create_clip
    from debiasing_multi_modal_tpu_torch.parallel import pp

    model = create_clip("ViT-B/32", dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(SEED)).requires_grad_(True)
    params = [p for p in model.visual.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    images = torch.randn(128, 224, 224, 3, device="cuda", generator=gen)
    target = torch.randn(128, 512, device="cuda", generator=gen)

    def grads(encode):
        loss = ((encode(images).float() - target) ** 2).mean()
        return [g.detach().clone() for g in torch.autograd.grad(loss, params)]

    ref = grads(model.encode_image)
    rows, launches, got = {}, {}, {}
    for name, remat, want in (("pipeline_vitb32_grad", False, 48),
                              ("pipeline_vitb32_grad_remat", True, 96)):
        def piped(x, remat=remat):
            return pp.pipelined_vit_encode(model, None, x, mesh=mesh, microbatches=4,
                                           batch_axis="data", remat=remat)
        _zero_counts()
        got[name] = grads(piped)
        torch.cuda.synchronize()
        launches[name] = _read_counts()
        _expect_counts(name, launches[name], {"short_attention": want})
        per = [_cos_flat(a, b) for a, b in zip(got[name], ref)]
        rows[name] = {"cos_min_per_param": min(per),
                      "cos_flat": _cos_flat(torch.cat([g.flatten() for g in got[name]]),
                                            torch.cat([g.flatten() for g in ref]))}
        if not (rows[name]["cos_min_per_param"] >= 0.99 and rows[name]["cos_flat"] >= 0.999):
            raise AssertionError(f"{name} disagrees with the unpipelined gradients: {rows}")
    plain, remat = got["pipeline_vitb32_grad"], got["pipeline_vitb32_grad_remat"]
    scale = max(g.abs().max().item() for g in plain)
    err = max((a - b).abs().max().item() for a, b in zip(remat, plain))
    rows["remat_vs_plain"] = {"max_abs_err": err, "scale": scale,
                              "bit_equal": all(torch.equal(a, b) for a, b in zip(remat, plain))}
    if err > 1e-6 * scale:
        raise AssertionError(f"remat gradients differ from remat off: {rows}")
    del model, got, ref
    torch.cuda.empty_cache()
    return rows, launches


def phase_parallel():
    """Data, tensor and sequence parallelism on a world-size-1 NCCL group
    (see the module docstring); returns the main paths' launch counts and
    the shard-shape kernel cases."""
    import torch
    import torch.distributed as dist

    from debiasing_multi_modal_tpu_torch.parallel import multihost
    from debiasing_multi_modal_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    with multihost.process_group("cuda"):
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        data_mesh = make_mesh((1,), ("data",), device="cuda")
        extraction, launches = _parallel_extraction(mesh, data_mesh)
        emit({"phase": "parallel", "backend": dist.get_backend(),
              "world": dist.get_world_size(), "extraction": extraction, "launches": launches})
        emit({"phase": "parallel", **_parallel_stage_b(data_mesh)})
        emit({"phase": "parallel", "attention": _parallel_attention(data_mesh)})
        t1 = time.perf_counter()
        pp_mesh = make_mesh((1, 1, 1, 1), ("data", "stage", "model", "seq"), device="cuda")
        encodes, pp_launches = _pipelined_encodes(pp_mesh)
        grads, grad_launches = _pipelined_gradients(pp_mesh)
        pp_launches.update(grad_launches)
        launches.update(pp_launches)
        emit({"phase": "parallel", "pipeline": {"encodes": encodes, "gradients": grads,
                                                "launches": pp_launches,
                                                "seconds": time.perf_counter() - t1}})
    cases = _shard_shape_cases(torch.Generator(device="cuda").manual_seed(SEED + 9))
    emit({"phase": "parallel", "seconds": time.perf_counter() - t0})
    return launches, cases



def _leaves_entry():
    """entry() on the card against the CPU: in f32 the predictions equal,
    the bf16 default's features within cosine 0.999 of the CPU's."""
    import torch

    from debiasing_multi_modal_tpu_torch.entry import entry

    out = {}
    for name, device, dtype in (("cpu", "cpu", None), ("card_f32", "cuda", torch.float32),
                                ("card_bf16", "cuda", None)):
        fn, args = entry(device=device, dtype=dtype)
        feats, preds = fn(*args)
        out[name] = (feats.float().cpu(), preds.cpu())
    row = {"preds_f32_equal": bool(torch.equal(out["card_f32"][1], out["cpu"][1])),
           "cos_min_f32": _cos_min(out["card_f32"][0], out["cpu"][0]),
           "cos_min_bf16": _cos_min(out["card_bf16"][0], out["cpu"][0]),
           "preds_bf16_equal_share": (out["card_bf16"][1] == out["cpu"][1]).float().mean().item()}
    if not (row["preds_f32_equal"] and row["cos_min_bf16"] >= 0.999):
        raise AssertionError(f"entry() on the card disagrees with the CPU: {row}")
    return row


def _leaves_augment():
    """train_augment's crop and flip of 256 uint8 256x256 images to 224 at
    boxes and flips drawn once on the CPU: card against CPU within 1e-5 of
    scale, and the card's images per second (CUDA events)."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.ops import augment

    rng = np.random.default_rng(SEED + 13)
    images = torch.from_numpy(rng.integers(0, 256, (256, 256, 256, 3), dtype=np.uint8))
    gen = torch.Generator().manual_seed(SEED + 13)
    boxes = augment.crop_boxes(gen, 256, 256, 256)
    flips = augment.flip_draws(gen, 256)

    def run(imgs, device):
        return augment.horizontal_flip(
            augment.resized_crop(imgs, *(b.to(device) for b in boxes), out_res=224),
            flips.to(device))

    ref = run(images, "cpu")
    card_images = images.cuda()
    got = run(card_images, "cuda").cpu()
    scale = ref.abs().max().item()
    row = {"max_abs_err": (got - ref).abs().max().item(), "scale": scale,
           "ms": time_ms(lambda: run(card_images, "cuda"), runs=5, calls=3, warmup=2)}
    row["imgs_per_s"] = 256 / row["ms"] * 1e3
    if row["max_abs_err"] > 1e-5 * scale:
        raise AssertionError(f"train_augment on the card disagrees with the CPU: {row}")
    return row


def _leaves_resnet():
    """A plain ResNet-50 train-mode SGD step at batch 64 in f32, card
    against CPU: the output and the updated running statistics within 1e-3
    of scale, the gradients by the standing limits (cosine >= 0.99 per
    parameter, >= 0.999 flattened; the same step in f64 on the card says
    how far f32 itself is from exact), and the bf16 forward's images per
    second at batch 256."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from debiasing_multi_modal_tpu_torch.models.resnet_plain import resnet50

    rng = np.random.default_rng(SEED + 14)
    x = torch.from_numpy(rng.standard_normal((64, 224, 224, 3)).astype(np.float32))
    tgt = torch.from_numpy(rng.standard_normal((64, 2048)).astype(np.float32))
    result = {}
    for name, device, dtype in (("cpu", "cpu", torch.float32), ("card", "cuda", torch.float32),
                                ("card_f64", "cuda", torch.float64)):
        model = resnet50(dtype=dtype, generator=torch.Generator().manual_seed(SEED))
        model = model.to(device=device, dtype=dtype).train()
        out = model(x.to(device))
        ((out - tgt.to(device, dtype)) ** 2).mean().backward()
        grads = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}
        stats = {k: v.double().cpu() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        result[name] = (out.detach().double().cpu(), grads, stats)
        del model, out
    (out_c, g_c, st_c), (out_g, g_g, st_g), (_, g_64, _) = (
        result["cpu"], result["card"], result["card_f64"])

    def rel(a, b, scale=None):
        return (a - b).abs().max().item() / (scale or max(b.abs().max().item(), 1e-30))

    def cos(a, b):
        return F.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()

    g_scale = max(g.abs().max().item() for g in g_64.values())
    row = {"out": rel(out_g, out_c), "running_stats": max(rel(st_g[k], st_c[k]) for k in st_c),
           "grads_cos_min": min(cos(g_g[n], g_c[n]) for n in g_c if g_c[n].abs().max() > 0),
           "grads_cos_flat": cos(torch.cat([g.flatten() for g in g_g.values()]),
                                 torch.cat([g.flatten() for g in g_c.values()])),
           "grads_card_vs_cpu": max(rel(g_g[n], g_c[n], g_scale) for n in g_c),
           "grads_card_f32_vs_f64": max(rel(g_g[n], g_64[n], g_scale) for n in g_c),
           "grads_cpu_f32_vs_card_f64": max(rel(g_c[n], g_64[n], g_scale) for n in g_c)}
    del result
    torch.cuda.empty_cache()
    model = resnet50(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED)).cuda()
    big = torch.randn(256, 224, 224, 3, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        model.eval()
        row["bf16_forward_imgs_per_s"] = _rate(lambda: model(big), 256, 5)
    if not (max(row["out"], row["running_stats"]) <= 1e-3 and row["grads_cos_min"] >= 0.99
            and row["grads_cos_flat"] >= 0.999):
        raise AssertionError(f"plain ResNet-50 step on the card disagrees with the CPU: {row}")
    del model, big
    torch.cuda.empty_cache()
    return row


def _leaves_linear_probe():
    """linear_probe on a CelebA-size synthetic table (162,770 x 1024, 2
    epochs) on the card against the CPU; one epoch under the sync check,
    its rows per second; then adapted_embeddings of the table."""
    import numpy as np
    import torch

    from debiasing_multi_modal_tpu_torch.data.samplers import epoch_plan
    from debiasing_multi_modal_tpu_torch.models.adapter import AdapterMLP
    from debiasing_multi_modal_tpu_torch.train import linear_eval
    from debiasing_multi_modal_tpu_torch.utils.staging import upload
    from debiasing_multi_modal_tpu_torch.viz.analysis import adapted_embeddings

    rng = np.random.default_rng(SEED + 15)
    n, d = 162770, 1024
    labels = rng.integers(0, 2, n)
    feats = (rng.standard_normal((n, d)) + 0.1 * labels[:, None]).astype(np.float32)
    kw = dict(epochs=2, batch_size=256, learning_rate=0.1)
    (w_c, acc_c), cpu_s = _host_timed(lambda: linear_eval.linear_probe(feats, labels,
                                                                        device="cpu", **kw))
    (w_g, acc_g), card_s = _host_timed(lambda: linear_eval.linear_probe(feats, labels,
                                                                         device="cuda", **kw))
    scale = max(np.abs(w_c["w"]).max(), np.abs(w_c["b"]).max())
    row = {"params_err": float(max(np.abs(w_g[k] - w_c[k]).max() for k in w_c) / scale),
           "acc_card": acc_g, "acc_cpu": acc_c, "card_s": card_s, "cpu_s": cpu_s}
    # one epoch alone under the sync check, timed
    dev = torch.device("cuda")
    params = {"w": torch.zeros(d, 2, device=dev, requires_grad=True),
              "b": torch.zeros(2, device=dev, requires_grad=True)}
    trace = {k: torch.zeros_like(v) for k, v in params.items()}
    table, labs = upload(feats, dev), upload(labels.astype(np.int64), dev)
    plan = epoch_plan(n, 256, shuffle=True, rng=np.random.default_rng(0))
    lrs = np.full(plan.num_batches, 0.1, np.float32)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with no_host_sync():
        idx, mask = upload(plan.indices.astype(np.int64), dev), upload(plan.mask, dev)
        linear_eval._linear_epoch(params, trace, table, labs, idx, mask, lrs,
                                  momentum=0.9, weight_decay=0.0)
    torch.cuda.synchronize()
    row["epoch_s"] = time.perf_counter() - t
    row["rows_per_s"] = n / row["epoch_s"]
    if not (row["params_err"] <= 1e-4 and abs(acc_g - acc_c) <= 5e-3):
        raise AssertionError(f"linear_probe on the card disagrees with the CPU: {row}")
    adapter = AdapterMLP(d, 128, generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():  # non-trivial running statistics
        bn = adapter.layers[1]
        bn.running_mean.copy_(torch.randn(128, generator=torch.Generator().manual_seed(1)))
        bn.running_var.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(2))
    ref = adapted_embeddings(adapter, None, None, feats[:32768], batch_size=4096)
    got = adapted_embeddings(adapter.cuda(), None, None, feats[:32768], batch_size=4096)
    row["adapted_rel_err"] = float(np.abs(got - ref).max() / np.abs(ref).max())
    if row["adapted_rel_err"] > 1e-5:
        raise AssertionError(f"adapted_embeddings on the card disagrees with the CPU: {row}")
    return row


def _leaves_zoo():
    """zoo.load of a seeded ViT-B/32 archive written by
    save_jit_state_dict_archive: its encode equals clip_from_state_dict's."""
    import torch

    from debiasing_multi_modal_tpu_torch.models import create_clip
    from debiasing_multi_modal_tpu_torch.weights import convert, zoo

    model = create_clip("ViT-B/32", device="cpu", generator=torch.Generator().manual_seed(SEED))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    del model
    images = torch.randn(16, 224, 224, 3, generator=torch.Generator().manual_seed(SEED),
                         device="cpu").cuda()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vit_b32.pt")
        _, write_s = _host_timed(lambda: convert.save_jit_state_dict_archive(sd, path))
        size_mb = os.path.getsize(path) / 2 ** 20
        loaded, load_s = _host_timed(lambda: zoo.load(path, device="cuda"))
    direct = convert.clip_from_state_dict(sd, device="cuda")
    with torch.no_grad():
        equal = bool(torch.equal(loaded.encode_image(images), direct.encode_image(images)))
    row = {"archive_mb": size_mb, "write_s": write_s, "load_s": load_s,
           "encode_equal": equal, "keys": len(sd)}
    del loaded, direct
    torch.cuda.empty_cache()
    if not equal:
        raise AssertionError(f"zoo.load's model differs from clip_from_state_dict's: {row}")
    return row


def _host_timed(fn):
    """(result, host seconds) of ``fn``."""
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def phase_leaves():
    """The side modules on the card against the CPU (see the module
    docstring); every kernel count stays 0."""
    t0 = time.perf_counter()
    _zero_counts()
    rows = {"entry": _leaves_entry(), "augment": _leaves_augment(),
            "resnet_plain": _leaves_resnet(), "linear_probe": _leaves_linear_probe()}
    launches = _read_counts()
    _expect_counts("leaves", launches, {})
    # after the counts: the check's ViT-B/32 encodes run kernel 1, zoo.load none
    rows["zoo"] = _leaves_zoo()
    emit({"phase": "leaves", **rows, "launches": launches,
          "seconds": time.perf_counter() - t0})
    return {"leaves": launches}


# the mini chain's sweep flags: 3 epochs, one seed, the real grids, each grid
# stacked into one program (the stacked CSVs are the per-cell path's bytes)
REPRO_SWEEP = ("--epochs 3 --epochs_feature_learning 1 --num_iter 1 --random_seeds 42 "
               "--stack_lr_axis --stack_bsr_axis --stack_bs_axis")
REPRO_N_PER_SPLIT = 64


def _run_checked(cmd, env=None, timeout=600):
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise AssertionError(f"{cmd[:3]} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    return proc.stdout


def _cache_gaps(card_dir, cpu_dir):
    """The card's Stage-A cache against the CPU's: predictions equal share,
    least per-row cosine of the image embeddings and of each text JSON."""
    import numpy as np

    card, cpu = (np.load(os.path.join(d, "RN50", "clip.npz")) for d in (card_dir, cpu_dir))
    for key in ("filenames", "y", "place", "group", "split"):
        if not np.array_equal(card[key], cpu[key]):
            raise AssertionError(f"reproduce: the caches' {key} differ")
    text = {}
    for kind in ("class", "spurious", "group"):
        rows = []
        for d in (card_dir, cpu_dir):
            with open(os.path.join(d, f"clip_{kind}.json")) as f:
                rows.append(np.array(list(json.load(f).values()), np.float32))
        text[kind] = _cos_min(*rows)
    return {"rows": int(len(cpu["y"])),
            "pred_equal": float((card["y_pred"] == cpu["y_pred"]).mean()),
            "image_cos_min": _cos_min(card["embeddings"], cpu["embeddings"]),
            "text_cos_min": text}


def phase_reproduce():
    """The reproduction chain on the card (see the module docstring); returns
    the kernel launches the chain's processes made."""
    import shutil

    from debiasing_multi_modal_tpu_torch.cli import extract_main
    from debiasing_multi_modal_tpu_torch.tokenizer import bpe

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_reproduce_")
    root, results = os.path.join(tmp, "assets"), os.path.join(tmp, "results")
    merges = os.path.join(tmp, "bpe_simple_vocab_16e6.txt.gz")
    seconds = {}
    try:
        t = time.perf_counter()
        _run_checked([sys.executable, "scripts/make_synthetic_fixture.py", root,
                      "--skip_checkpoint", "--n_per_split", str(REPRO_N_PER_SPLIT)])
        _run_checked([sys.executable, "scripts/make_synthetic_checkpoint_torch.py", root,
                      "--geometry", "RN50"])
        bpe.write_synthetic_merges(merges)
        seconds["fixture"] = time.perf_counter() - t
        env = dict(os.environ, CLIP_BPE_PATH=merges, REPRO_DATA_ROOT=root,
                   REPRO_RESULT_ROOT=results, REPRO_CKPT=os.path.join(root, "RN50.pt"),
                   REPRO_DEVICE="cuda", REPRO_EXTRACT_ARGS="--batch_size 64",
                   REPRO_SWEEP_ARGS=REPRO_SWEEP, REPRO_CHECK_ARGS="--structural",
                   REPRO_ABLATIONS="0")
        t = time.perf_counter()
        out = _run_checked(["bash", "scripts/reproduce_all_torch.sh"], env=env, timeout=900)
        seconds["chain_host_clock"] = time.perf_counter() - t
        for line in out.splitlines():
            if m := re.match(r"stage (\w+): (\d+) ms$", line):
                seconds[m.group(1)] = int(m.group(2)) / 1e3
        per_process = [json.loads(line.split(":", 1)[1]) for line in out.splitlines()
                       if line.startswith("kernel launches:")]
        # extract_main's own per-split rate on the card, host clock
        card_imgs_per_s = [float(m.group(1)) for m in
                           re.finditer(r"^\w+: \d+ images in [\d.]+s \((\d+) imgs/s\)$", out,
                                       re.MULTILINE)]
        if len(per_process) != 2:
            raise AssertionError(f"reproduce: {len(per_process)} extract_main launch lines")
        launches = {name: sum(p["launches"][name] for p in per_process)
                    for name in _read_counts()}
        for p in per_process:
            _expect_counts("reproduce extract_main", p["launches"],
                           {"short_attention": 12 * p["text_encodes"]})
        for cell in ("ds_waterbirds_tl_adapter_reg_seq_alter_bs_1024_lr_1.0_lrr1.0_bsr256_"
                     "MA+rn.csv",
                     "ds_celeba_tl_adapter_reg_seq_alter_bs_1024_lr_0.1_lrr1.0_bsr4_balval_"
                     "MA+rn.csv"):
            with open(os.path.join(results, cell)) as f:
                if "worst_acc" not in f.read():
                    raise AssertionError(f"reproduce: {cell} lacks worst_acc")
        if "structural check only" not in out:
            raise AssertionError("reproduce: check_vs_baseline did not run its structural check")

        # the same extract_main on the CPU, in this process (f32)
        t = time.perf_counter()
        old = os.environ.get("CLIP_BPE_PATH")
        os.environ["CLIP_BPE_PATH"] = merges
        bpe.default_tokenizer.cache_clear()
        try:
            for dataset in ("celeba", "waterbirds"):
                extract_main.main(extract_main.build_parser().parse_args([
                    "--data_dir", root, "--dataset", dataset, "--embedding_dir", "emb_cpu",
                    "--save", "--split", "all", "--backbone", "RN50", "--batch_size", "64",
                    "--checkpoint", os.path.join(root, "RN50.pt"), "--device", "cpu"]))
        finally:
            if old is None:
                os.environ.pop("CLIP_BPE_PATH")
            else:
                os.environ["CLIP_BPE_PATH"] = old
            bpe.default_tokenizer.cache_clear()
        seconds["extract_cpu"] = time.perf_counter() - t
        gaps = {ds: _cache_gaps(os.path.join(root, "embeddings_unnormalized", ds),
                                os.path.join(root, "emb_cpu", ds))
                for ds in ("waterbirds", "celeba")}
        for ds, g in gaps.items():
            if not (g["pred_equal"] >= 0.99 and g["image_cos_min"] >= 0.999
                    and min(g["text_cos_min"].values()) >= 0.999):
                raise AssertionError(f"reproduce: the card's {ds} cache against the CPU's: {g}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "reproduce", "geometry": "RN50", "images_per_split": REPRO_N_PER_SPLIT,
          "sweep_args": REPRO_SWEEP, "seconds": seconds,
          "card_imgs_per_s_by_split": card_imgs_per_s, "cache_vs_cpu": gaps,
          "launches": launches, "text_encodes": sum(p["text_encodes"] for p in per_process),
          "phase_seconds": time.perf_counter() - t_phase})
    return {"reproduce": launches}


F32_DESIGN = ("f32 on the CUDA cores from register tiles (attention_f32.cuh: 16x16 threads, "
              "4x8 logits and 4x4 outputs a thread at 64 query rows, 16-byte cp.async into "
              "swizzled shared memory, warp-per-row exact softmax)")
TC_DESIGN = ("CUDA C++; bf16 on the tensor cores (mma.sync.m16n8k16, ldmatrix, 16-byte "
             "cp.async into swizzled shared memory); " + F32_DESIGN)
QTILED_DESIGN = ("CUDA C++; bf16 kernel 1's two-pass tensor-core path (mma.sync.m16n8k16, "
                 "Q fragments in registers, 16-row warp tiles, 128-row q tiles) with K and V "
                 "streamed through a three-stage ring of 64-key chunks by 16-byte "
                 "cp.async (K alone for pass 1, K and V for pass 2); " + F32_DESIGN
                 + ", K/V streamed through double-buffered key tiles")
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
                     "from the swizzled y1 / y2 tiles at each lane's shifted pixel; f32 the "
                     "same device code as split-TF32: three mma.sync.m16n8k8 TF32 products "
                     "per product, hi/lo split on each fragment load, 16-deep f32 k-tiles)")
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
    parser.add_argument("--only", choices=["flash_f32", "qtiled_bf16", "rn50_blocks",
                                           "vitl14_336_bf16",
                                           "stage_b", "contrastive", "sweep", "native_json",
                                           "parallel", "leaves", "reproduce"],
                        help="flash_f32: build, then only the timed f32 cases of kernels 4-6 "
                             "and the f32 128-pair training step; qtiled_bf16: build, then "
                             "only bf16 kernel 2's cases (timed at S=1025 beside SDPA); "
                             "rn50_blocks: build, fold the seeded RN50, then only the "
                             "rn50_blocks phase (kernels 8-9, bf16 and f32); "
                             "vitl14_336_bf16: build, then only kernel 1 at ViT-L/14@336px's "
                             "image shape (timed beside kernel 2, which must equal it) and "
                             "the bf16 ViT-L/14@336px batch; each times "
                             "another tree's kernels with this script; "
                             "stage_b, contrastive, sweep, native_json: only that phase (no "
                             "kernel to build); parallel: build, then only that phase; "
                             "leaves: only the side modules (no kernel runs); reproduce: "
                             "build, then only the reproduction chain; none "
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
    if args.only == "qtiled_bf16":
        import torch

        phase_build(check=False)
        _qtiled_bf16_cases(torch.Generator(device="cuda").manual_seed(SEED))
        emit({"phase": "summary", "only": args.only, "seconds": time.perf_counter() - t0})
        return 0
    if args.only in ("stage_b", "contrastive", "sweep", "native_json", "leaves"):
        {"stage_b": phase_stage_b, "contrastive": phase_contrastive,
         "sweep": phase_sweep, "native_json": phase_native_json,
         "leaves": phase_leaves}[args.only]()
        emit({"phase": "summary", "only": args.only, "seconds": time.perf_counter() - t0})
        return 0
    if args.only in ("parallel", "reproduce"):
        phase_build(check=False)
        {"parallel": phase_parallel, "reproduce": phase_reproduce}[args.only]()
        emit({"phase": "summary", "only": args.only, "seconds": time.perf_counter() - t0})
        return 0
    if args.only == "vitl14_336_bf16":
        import torch

        from debiasing_multi_modal_tpu_torch.ops import short_attention as sa

        phase_build(check=False)
        _attention_case(sa.short_attention, sa.short_attention_reference,
                        *VITL14_336_IMAGE, torch.bfloat16, 2e-2,
                        torch.Generator(device="cuda").manual_seed(SEED), True,
                        twin=sa.short_attention_qtiled)
        phase_vitl14_336_bf16()
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
    launches.update(phase_vitl14_336_bf16())
    launches.update(phase_train())
    launches.update(phase_stage_b())
    launches.update(phase_contrastive())
    launches.update(phase_sweep())
    launches.update(phase_native_json())
    parallel_launches, shard_cases = phase_parallel()
    launches.update(parallel_launches)
    for name, rows in shard_cases.items():
        cases[name] += rows
    launches.update(phase_leaves())
    launches.update(phase_reproduce())
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
