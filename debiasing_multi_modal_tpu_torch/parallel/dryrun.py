"""The multi-rank dry run (the port's counterpart of
``__graft_entry__.py::dryrun_multichip``).

:func:`dryrun_multichip` runs, on ``n`` ranks started by
``parallel/multihost.launch`` (gloo CPU processes, or one rank per card on
NCCL), the checks of the JAX dry run:

- one epoch of two adapter SGD steps on a dp x tp mesh (tp = 2 when n is
  even and at least 4): rows over ``data``, and over ``model`` fc1
  column-parallel, the BatchNorm split on the hidden features and fc2
  row-parallel; parameters and meters equal to the unsharded epoch's;
- data-parallel extraction of a tiny ViT, and with ``fuse_qkv`` (the packed
  attention, kernel 3 on the card) to the same embeddings and predictions;
- tensor-parallel extraction of the ViT and of a ResNet's attention pool,
  equal to data-parallel only;
- the seed-sharded and the grid-stacked sweep over the ranks, equal to the
  unsharded stacked sweep;
- kernel 1 and kernel 4's forward on each rank's own rows of a batch (no
  gather of q, k, v), kernel 1 within 2e-5 of its plain version;
- ring and Ulysses attention over all ranks, equal to plain attention;
- a tiny text tower's 4-layer stack pipelined over 4 stages (2 when n is
  even but not a multiple of 4) with the rest of the ranks on ``data``, or
  over dp x pp 2 x tp 2 x sp 2 when n is a multiple of 8, with GPipe
  microbatches, equal to the sequential stack (``parallel/pp.py``).

Every check raises on a mismatch; each rank returns what it checked.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

from debiasing_multi_modal_tpu_torch.utils.platform import DeviceLike, resolve_device

TOL = 2e-5


def _close(a, b, what, tol=TOL):
    a, b = (torch.as_tensor(x).detach().float().cpu() for x in (a, b))
    err = (a - b).abs().max().item() if a.numel() else 0.0
    if not (a.shape == b.shape and err <= tol * max(1.0, b.abs().max().item())):
        raise AssertionError(f"{what}: max abs err {err} (shapes {a.shape}, {b.shape})")
    return err


def _adapter_step(mesh, device) -> Dict[str, float]:
    """The dp x tp adapter epoch against the unsharded one."""
    from torch import nn

    from debiasing_multi_modal_tpu_torch.models.adapter import AdapterClassifier, MaskedBatchNorm
    from debiasing_multi_modal_tpu_torch.parallel.mesh import (
        RowShard,
        axis_group,
        axis_rank,
        axis_size,
        gather_rows,
    )
    from debiasing_multi_modal_tpu_torch.parallel.tp import (
        RowParallelLinear,
        _copy_hook,
        _narrowed,
    )
    from debiasing_multi_modal_tpu_torch.train.steps import init_train_state, ones_mask, train_epoch

    dp, tp = axis_size(mesh, "data"), axis_size(mesh, "model")
    dim, hidden, bs, nb = 64, 32, 8 * dp, 2
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.standard_normal((bs * nb, dim)).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, 2, bs * nb)).to(device)
    groups = torch.from_numpy(rng.integers(0, 4, bs * nb)).to(device)
    text = torch.from_numpy(rng.standard_normal((dim, 2)).astype(np.float32)).to(device)
    idx = torch.arange(bs * nb, device=device).reshape(nb, bs)
    mask = torch.ones(nb, bs, dtype=torch.bool, device=device)
    lrs = np.full(nb, 0.1, np.float32)
    full = AdapterClassifier(dim, hidden, 0.01, generator=torch.Generator().manual_seed(0))
    full = full.to(device)

    # the sharded module: fc1 rows, the BatchNorm's features and fc2's
    # columns of this model rank; the input enters through Megatron's f
    local = copy.deepcopy(full)
    mlp = local.adapter
    fc1, bn, _, fc2 = mlp.layers
    block = slice(axis_rank(mesh, "model") * hidden // tp,
                  (axis_rank(mesh, "model") + 1) * hidden // tp)
    small_bn = MaskedBatchNorm(hidden // tp).to(device)
    small_bn.load_state_dict({k: (v[block] if v.dim() else v) for k, v in bn.state_dict().items()})
    mlp.layers = nn.ModuleList([
        _narrowed(fc1, block), small_bn, nn.ReLU(),
        RowParallelLinear(fc2, block, axis_group(mesh, "model"), axis_rank(mesh, "model"),
                          torch.float32)])
    mlp.register_forward_pre_hook(_copy_hook(axis_group(mesh, "model")))

    ref_state, ref_stats = train_epoch(init_train_state(full), emb, labels, groups, idx, mask,
                                       lrs, text, ones_mask(dict(full.named_parameters())))
    shard = RowShard.of(bs * nb, axis_group(mesh, "data"))
    state, stats = train_epoch(init_train_state(local), shard.take(emb), labels, groups, idx,
                               mask, lrs, text, ones_mask(dict(local.named_parameters())),
                               shard=shard)
    model_group = axis_group(mesh, "model")
    got = dict(state.module.named_parameters())
    got.update(state.module.named_buffers())
    want = dict(ref_state.module.named_parameters())
    want.update(ref_state.module.named_buffers())
    errs = {}
    for name, w in want.items():
        g = got[name]
        if name.endswith("layers.3.weight"):  # fc2: columns per model rank
            g = gather_rows(g.t().contiguous(), model_group).t()
        elif g.shape != w.shape:  # fc1 and the BatchNorm: rows per model rank
            g = gather_rows(g.contiguous(), model_group)
        errs[name] = _close(g, w, f"adapter dp x tp {name}", 1e-5)
    for a, b, what in zip(stats, ref_stats, ("corrects", "counts", "loss_sum", "n")):
        _close(a, b, f"adapter meters {what}", 1e-5)
    return errs


def _tiny_clip_configs():
    from debiasing_multi_modal_tpu_torch.models.config import CLIPConfig

    vit = CLIPConfig(name="dryrun-vit", embed_dim=32, image_resolution=32, vision_layers=1,
                     vision_width=128, vision_patch_size=16, transformer_width=64,
                     transformer_heads=2, transformer_layers=1)
    rn = CLIPConfig(name="dryrun-rn", embed_dim=32, image_resolution=32,
                    vision_layers=(1, 1, 1, 1), vision_width=8, vision_patch_size=None,
                    transformer_width=64, transformer_heads=2, transformer_layers=1)
    return vit, rn


def _extraction(mesh, data_mesh, n, device) -> List[str]:
    from debiasing_multi_modal_tpu_torch.extract.runner import ExtractionRunner
    from debiasing_multi_modal_tpu_torch.models import create_clip
    from debiasing_multi_modal_tpu_torch.parallel.mesh import axis_size

    done = []
    vit_cfg, rn_cfg = _tiny_clip_configs()
    rng = np.random.default_rng(1)
    zs = rng.standard_normal((2, 32)).astype(np.float32)
    images = (rng.random((n * 2, 32, 32, 3)) * 255).astype(np.uint8)
    dtype = torch.float32

    def clip(cfg, seed, **kw):
        return create_clip(cfg, dtype=dtype, device=device,
                           generator=torch.Generator().manual_seed(seed), **kw)

    model = clip(vit_cfg, 1)
    e, p = ExtractionRunner(model, zs, mesh=data_mesh).encode_batch(images)
    if e.shape != (n * 2, 32):
        raise AssertionError(f"dp extraction gave {e.shape}")
    done.append("dp extraction")
    fused = clip(vit_cfg, 1, attn_impl="short", fuse_qkv=True)
    e_f, p_f = ExtractionRunner(fused, zs, mesh=data_mesh).encode_batch(images)
    _close(e_f, e, "fuse_qkv dp extraction")
    np.testing.assert_array_equal(p_f, p)
    done.append("fuse_qkv dp extraction == unfused")
    if axis_size(mesh, "model") >= 2:
        e_tp, p_tp = ExtractionRunner(model, zs, mesh=mesh, tensor_parallel=True).encode_batch(images)
        _close(e_tp, e, "tp ViT extraction")
        np.testing.assert_array_equal(p_tp, p)
        rn = clip(rn_cfg, 2)
        e_rn, p_rn = ExtractionRunner(rn, zs, mesh=data_mesh).encode_batch(images)
        e_rt, p_rt = ExtractionRunner(rn, zs, mesh=mesh, tensor_parallel=True).encode_batch(images)
        _close(e_rt, e_rn, "tp RN attnpool extraction")
        np.testing.assert_array_equal(p_rt, p_rn)
        done.append("tp ViT and RN attnpool extraction == dp only")
    return done


def _sweeps(data_mesh, n, device) -> List[str]:
    from debiasing_multi_modal_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_dataset
    from debiasing_multi_modal_tpu_torch.sweep.runner import run_seeds
    from debiasing_multi_modal_tpu_torch.sweep.vmap_loop import train_seeds_vmapped
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
    from debiasing_multi_modal_tpu_torch.train.loop import bundle_from_embedding_table

    meta, table, tc, tg, ts = make_synthetic_dataset(
        SyntheticSpec(n_train=128, n_val=64, n_test=64, dim=32))
    bundle = bundle_from_embedding_table(
        table, {name: meta.take(np.where(meta.split == s)[0])
                for name, s in (("train", 0), ("val", 1), ("test", 2))},
        tc, ts, tg, device=device)
    cfg = TrainConfig(tl_method="adapter_reg_seq_alter", epochs=2, epochs_feature_learning=1,
                      balance_val=True, dataset="waterbirds", input_dim=32,
                      adapter_feat_dim=8, batch_size=32, batch_size_reg=8, learning_rate=0.5,
                      learning_rate_reg=0.5, lr_decay_epochs=(100,))
    seeds = list(range(42, 42 + n))
    plain = run_seeds(cfg, bundle, seeds, device=device)
    sharded = run_seeds(cfg, bundle, seeds, mesh=data_mesh, device=device)
    if plain != sharded:
        raise AssertionError("seed-sharded sweep != unsharded stacked sweep")
    axes = [(bsr, bs) for bsr in (8, 16) for bs in (16, 32)]
    grid = [cfg.replace(learning_rate=0.5 + 0.25 * (i // len(axes)),
                        batch_size_reg=axes[i % len(axes)][0],
                        batch_size=axes[i % len(axes)][1]) for i in range(n)]
    plain_g = train_seeds_vmapped(cfg, bundle, [42], cell_grid=grid, device=device)
    sharded_g = train_seeds_vmapped(cfg, bundle, [42], cell_grid=grid, mesh=data_mesh,
                                    device=device)
    if plain_g != sharded_g:
        raise AssertionError("grid-stacked sweep over the ranks != unsharded")
    return [f"seed-sharded sweep ({n} seeds)", f"grid-stacked sweep ({n} cells)"]


def _kernels_on_shards(data_mesh, n, device) -> List[str]:
    from debiasing_multi_modal_tpu_torch.ops import flash_attention as fa
    from debiasing_multi_modal_tpu_torch.ops import short_attention as sa
    from debiasing_multi_modal_tpu_torch.parallel.mesh import axis_rank, batch_rows

    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2 * n, 50, 128, generator=gen).to(device) for _ in range(3))
    rank = axis_rank(data_mesh, "data")
    ql, kl, vl = (batch_rows(x, n, rank) for x in (q, k, v))  # this rank's rows only
    out = sa.short_attention(ql, kl, vl, 2, causal=True)
    _close(out, sa.short_attention_reference(ql, kl, vl, 2, causal=True),
           "kernel 1 on a batch shard")
    q4, k4, v4 = (x.reshape(2, 50, 2, 64) for x in (ql, kl, vl))
    if not torch.isfinite(fa.flash_attention(q4, k4, v4)).all():
        raise AssertionError("kernel 4 on a batch shard is not finite")
    return ["kernels 1 and 4 on batch shards"]


def _sequence_parallel(data_mesh, n, device) -> List[str]:
    from debiasing_multi_modal_tpu_torch.ops.attention import _xla_attention
    from debiasing_multi_modal_tpu_torch.ops.ring_attention import sequence_parallel_attention
    from debiasing_multi_modal_tpu_torch.ops.ulysses_attention import (
        ulysses_sequence_parallel_attention,
    )

    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 8 * n, 2, 32, generator=gen).to(device) for _ in range(3))
    ring = sequence_parallel_attention(q, k, v, mesh=data_mesh, axis_name="data", causal=True)
    _close(ring, _xla_attention(q, k, v, causal=True), "ring attention")
    q, k, v = (torch.randn(2, 8 * n, n, 16, generator=gen).to(device) for _ in range(3))
    uly = ulysses_sequence_parallel_attention(q, k, v, mesh=data_mesh, axis_name="data",
                                              causal=True)
    _close(uly, _xla_attention(q, k, v, causal=True), "ulysses attention")
    return ["ring attention", "ulysses attention"]


def _pipeline(n, device) -> List[str]:
    from debiasing_multi_modal_tpu_torch.models import create_clip
    from debiasing_multi_modal_tpu_torch.models.config import CLIPConfig
    from debiasing_multi_modal_tpu_torch.parallel.mesh import make_mesh
    from debiasing_multi_modal_tpu_torch.parallel.pp import (
        pipeline_transformer,
        stack_block_params,
    )

    stages = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    if stages == 1:
        return []
    cfg = CLIPConfig(name="dryrun-pp", embed_dim=32, image_resolution=32, vision_layers=1,
                     vision_width=128, vision_patch_size=16, transformer_width=64,
                     transformer_heads=2, transformer_layers=4, vocab_size=128)
    model = create_clip(cfg, dtype=torch.float32, device=device,
                        generator=torch.Generator().manual_seed(3))
    stacked, n_layers = stack_block_params(model.transformer)
    four_d = n % 8 == 0
    if four_d:  # dp x pp x tp x sp on one mesh
        stages, tp, sp = 2, 2, 2
        dp = n // 8
        mesh = make_mesh((dp, stages, tp, sp), ("data", "stage", "model", "seq"),
                         device=device.type)
    else:
        tp = sp = 1
        dp = n // stages
        mesh = make_mesh((dp, stages), ("data", "stage"), device=device.type)
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(rng.standard_normal((4 * dp, 64, 64)).astype(np.float32)).to(device)
    with torch.no_grad():
        seq = model.transformer(xs)  # the text tower's stack is causal
        piped = pipeline_transformer(stacked, xs, mesh=mesh, num_heads=2, microbatches=2,
                                     causal=True, batch_axis="data",
                                     model_axis="model" if four_d else None,
                                     seq_axis="seq" if four_d else None)
    _close(piped, seq, "pipeline parallel")
    return [f"pipeline parallel: {n_layers} layers over {stages} stages x dp={dp} x tp={tp} "
            f"x sp={sp} == sequential stack"]


def dryrun_rank(device: str) -> List[str]:
    """Every check on this rank of the launched world."""
    import torch.distributed as dist

    from debiasing_multi_modal_tpu_torch.parallel.mesh import make_mesh

    n = dist.get_world_size()
    dev = torch.device(device) if device == "cpu" else torch.device("cuda", dist.get_rank())
    tp = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh((n // tp, tp), ("data", "model"), device=device)
    data_mesh = make_mesh((n,), ("data",), device=device)
    done = [f"adapter dp={n // tp} x tp={tp} epoch == unsharded "
            f"(max err {max(_adapter_step(mesh, dev).values()):.2e})"]
    done += _extraction(mesh, data_mesh, n, dev)
    done += _sweeps(data_mesh, n, dev)
    done += _kernels_on_shards(data_mesh, n, dev)
    done += _sequence_parallel(data_mesh, n, dev)
    done += _pipeline(n, dev)
    return done


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda",
                     timeout_s: float = 600.0) -> List[str]:
    """Run every check on ``n_devices`` ranks; raises on the first failure,
    returns (and prints) what rank 0 checked."""
    from debiasing_multi_modal_tpu_torch.parallel.multihost import launch

    dev = resolve_device(device)
    done = launch(dryrun_rank, n_devices, args=(dev.type,), device=dev, timeout_s=timeout_s)[0]
    for line in done:
        print(f"dryrun ({n_devices} ranks, {dev.type}): {line} ok")
    return done
