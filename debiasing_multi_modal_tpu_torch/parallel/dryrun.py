"""The multi-rank dry run (the port's counterpart of
``__graft_entry__.py::dryrun_multichip``).

:func:`dryrun_multichip` runs, on ``n`` ranks started by
``parallel/multihost.launch`` (gloo CPU processes, or one rank per card on
NCCL), the checks of the JAX dry run:

- one epoch of two adapter SGD steps on a dp x tp mesh (tp = 2 when n is
  even and at least 4): rows over ``data``, and over ``model`` fc1
  column-parallel, the BatchNorm split on the hidden features and fc2
  row-parallel; in float64 the parameters equal the unsharded epoch's within
  1e-12 of scale, and in f32 they lie as close to the float64 epoch as the
  unsharded epoch with its sums reordered does (``_adapter_step``); the
  meters equal the unsharded epoch's;
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


def _adapter_problem(dp: int, device, dtype):
    """The epoch's data and its unsharded classifier, in ``dtype``."""
    from debiasing_multi_modal_tpu_torch.models.adapter import AdapterClassifier

    dim, hidden, bs, nb = 64, 32, 8 * dp, 2
    rng = np.random.default_rng(0)
    data = dict(
        emb=torch.from_numpy(rng.standard_normal((bs * nb, dim))).to(device, dtype),
        labels=torch.from_numpy(rng.integers(0, 2, bs * nb)).to(device),
        groups=torch.from_numpy(rng.integers(0, 4, bs * nb)).to(device),
        text=torch.from_numpy(rng.standard_normal((dim, 2))).to(device, dtype),
        idx=torch.arange(bs * nb, device=device).reshape(nb, bs),
        mask=torch.ones(nb, bs, dtype=torch.bool, device=device),
        lrs=np.full(nb, 0.1, np.float32))
    full = AdapterClassifier(dim, hidden, 0.01, generator=torch.Generator().manual_seed(0))
    return data, full.to(device, dtype)


def _state_of(module) -> Dict[str, torch.Tensor]:
    named = dict(module.named_parameters())
    named.update(module.named_buffers())
    return named


# the adapter's tensors indexed by its hidden units: fc1's and the
# BatchNorm's rows, and fc2's columns
_HIDDEN_ROWS = tuple(f"adapter.layers.{i}.{t}" for i, t in (
    (0, "weight"), (0, "bias"), (1, "weight"), (1, "bias"), (1, "running_mean"),
    (1, "running_var")))
_HIDDEN_COLUMNS = "adapter.layers.3.weight"


def _unsharded_epoch(full, data, rows=None, hidden=None):
    """The plain epoch; ``rows`` reorders each batch's rows and ``hidden``
    the adapter's hidden units: the same function with its sums in another
    order.  Returns the final state in the original order, and the meters."""
    from debiasing_multi_modal_tpu_torch.train.steps import init_train_state, ones_mask, train_epoch

    module = copy.deepcopy(full)
    if hidden is not None:
        start = _state_of(module)
        with torch.no_grad():
            for name in _HIDDEN_ROWS:
                start[name].copy_(start[name][hidden])
            start[_HIDDEN_COLUMNS].copy_(start[_HIDDEN_COLUMNS][:, hidden])
    idx = data["idx"] if rows is None else data["idx"][:, rows]
    state, stats = train_epoch(init_train_state(module), data["emb"], data["labels"],
                               data["groups"], idx, data["mask"], data["lrs"], data["text"],
                               ones_mask(dict(module.named_parameters())))
    out = _state_of(state.module)
    if hidden is not None:
        back = torch.argsort(hidden)
        for name in _HIDDEN_ROWS:
            out[name] = out[name][back]
        out[_HIDDEN_COLUMNS] = out[_HIDDEN_COLUMNS][:, back]
    return out, stats


def _sharded_epoch(full, data, mesh, device):
    """The dp x tp epoch; returns the state gathered to the unsharded
    shapes, and the meters."""
    from torch import nn

    from debiasing_multi_modal_tpu_torch.models.adapter import MaskedBatchNorm
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

    tp, dtype = axis_size(mesh, "model"), data["emb"].dtype
    rows, hidden = data["emb"].shape[0], full.adapter.layers[0].out_features
    # the sharded module: fc1 rows, the BatchNorm's features and fc2's
    # columns of this model rank; the input enters through Megatron's f
    local = copy.deepcopy(full)
    mlp = local.adapter
    fc1, bn, _, fc2 = mlp.layers
    model_group, model_rank = axis_group(mesh, "model"), axis_rank(mesh, "model")
    block = slice(model_rank * hidden // tp, (model_rank + 1) * hidden // tp)
    small_bn = MaskedBatchNorm(hidden // tp).to(device, dtype)
    small_bn.load_state_dict({k: (v[block] if v.dim() else v) for k, v in bn.state_dict().items()})
    mlp.layers = nn.ModuleList([
        _narrowed(fc1, block), small_bn, nn.ReLU(),
        RowParallelLinear(fc2, block, model_group, model_rank, dtype)])
    mlp.register_forward_pre_hook(_copy_hook(model_group))
    shard = RowShard.of(rows, axis_group(mesh, "data"))
    state, stats = train_epoch(init_train_state(local), shard.take(data["emb"]), data["labels"],
                               data["groups"], data["idx"], data["mask"], data["lrs"],
                               data["text"], ones_mask(dict(local.named_parameters())),
                               shard=shard)
    got = _state_of(state.module)
    for name, want in _state_of(full).items():
        g = got[name]
        if name.endswith("layers.3.weight"):  # fc2: columns per model rank
            got[name] = gather_rows(g.t().contiguous(), model_group).t()
        elif g.shape != want.shape:  # fc1 and the BatchNorm: rows per model rank
            got[name] = gather_rows(g.contiguous(), model_group)
    return got, stats


def _distance(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Max abs difference per tensor over ``b``'s scale (at least 1), in float64."""
    out = {}
    for name, w in b.items():
        x, y = a[name].detach().double().cpu(), w.detach().double().cpu()
        if x.shape != y.shape:
            raise AssertionError(f"adapter {name}: shapes {x.shape}, {y.shape}")
        if not torch.is_floating_point(w):
            continue
        out[name] = ((x - y).abs().max() / max(1.0, y.abs().max().item())).item()
    return out


# The float64 identity check: the sharded epoch is the unsharded one with its
# sums in another order, so in float64 the two differ by the rounding of
# float64 alone.  Measured on the CPU ranks: 3.5e-15 of scale at 8 ranks and
# 8.4e-16 at 4 (``dryrun_multichip(n, device="cpu")``'s adapter line); a
# wrong sum (a dropped shard, a doubled all-reduce) moves a parameter by
# 1e-3 or more of scale.
F64_LIMIT = 1e-12
# The f32 check, derived from the f32 order noise at this very shape.  Each of
# REORDERINGS runs the unsharded epoch with its rows and hidden units in
# another order: the same function, every sum in another order, as sharding
# does.  Their largest distance to the float64 epoch is the spread that order
# alone gives in f32 (the step's temperature of 0.01 multiplies the logits'
# rounding by 100).  The sharded epoch is one more order, so its distance to
# float64 must lie within ORDER_FACTOR times that spread, plus F32_FLOOR, one
# f32 ulp of scale (twice the half ulp by which storing a float64 result in
# f32 alone moves it), for the case where the spread comes out near zero.
# ORDER_FACTOR = 2: the sharded epoch is one more draw of this noise.  At 8
# ranks the five unsharded draws lie 5.8e-6 to 1.98e-5 from float64 (the
# largest 3.4 times the smallest) and the sharded one 1.61e-5; at 4 ranks
# 6.2e-7 to 9.2e-7 and 8.1e-7.  Twice the largest draw leaves room for one
# more draw's spread; an error in the sharded arithmetic itself is the float64
# check's to catch.
REORDERINGS = 4
ORDER_FACTOR = 2.0
F32_FLOOR = 2.0 ** -23


def _adapter_step(mesh, device) -> Dict[str, float]:
    """The dp x tp adapter epoch against the unsharded one: in float64
    within :data:`F64_LIMIT`, and in f32 within the f32 order noise of the
    unsharded epoch at this shape (see :data:`ORDER_FACTOR`).  Returns the
    distances; the f32 meters must match within 1e-5."""
    from debiasing_multi_modal_tpu_torch.parallel.mesh import axis_size

    dp = axis_size(mesh, "data")
    data64, full64 = _adapter_problem(dp, device, torch.float64)
    plain64, _ = _unsharded_epoch(full64, data64)
    sharded64, _ = _sharded_epoch(full64, data64, mesh, device)
    f64 = max(_distance(sharded64, plain64).values())
    if not f64 <= F64_LIMIT:
        raise AssertionError(f"adapter dp x tp float64 epoch: {f64:.2e} of scale from the "
                             f"unsharded one (limit {F64_LIMIT:.0e})")

    data, full = _adapter_problem(dp, device, torch.float32)
    plain, ref_stats = _unsharded_epoch(full, data)
    sharded, stats = _sharded_epoch(full, data, mesh, device)
    noise = [max(_distance(plain, plain64).values())]
    gen = torch.Generator().manual_seed(7)
    hidden = full.adapter.layers[0].out_features
    for _ in range(REORDERINGS):
        rows = torch.randperm(data["idx"].shape[1], generator=gen).to(device)
        units = torch.randperm(hidden, generator=gen).to(device)
        noise.append(max(_distance(_unsharded_epoch(full, data, rows, units)[0],
                                   plain64).values()))
    f32 = max(_distance(sharded, plain64).values())
    limit = ORDER_FACTOR * max(noise) + F32_FLOOR
    if not f32 <= limit:
        raise AssertionError(
            f"adapter dp x tp f32 epoch: {f32:.2e} of scale from float64, past "
            f"{ORDER_FACTOR} x the unsharded epoch's order noise {max(noise):.2e} "
            f"+ {F32_FLOOR:.1e} = {limit:.2e}")
    for a, b, what in zip(stats, ref_stats, ("corrects", "counts", "loss_sum", "n")):
        _close(a, b, f"adapter meters {what}", 1e-5)
    return {"f64": f64, "f32": f32, "f32_unsharded": noise[0], "f32_order_noise": max(noise),
            "f32_limit": limit, "f32_to_unsharded": max(_distance(sharded, plain).values())}


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
    adapter = _adapter_step(mesh, dev)
    done = [f"adapter dp={n // tp} x tp={tp} epoch == unsharded in float64 "
            f"(within {F64_LIMIT:.0e} of scale)",
            f"adapter dp={n // tp} x tp={tp} epoch in f32 within the order noise "
            f"(distances to float64: {adapter['f32']:.2e} sharded, "
            f"{adapter['f32_unsharded']:.2e} unsharded, {adapter['f32_order_noise']:.2e} "
            f"reordered; limit {adapter['f32_limit']:.2e}; float64 {adapter['f64']:.1e})"]
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
