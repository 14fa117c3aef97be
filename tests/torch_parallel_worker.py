"""Rank functions for the port's multi-rank tests (tests/test_torch_*.py).

``parallel/multihost.launch`` pickles a function by its import path and runs
it on fresh processes, one rank each, on gloo.  These functions import the
port only (never ``jax``), so the ranks start fast and the JAX side stays in
the test process, on its 8-device CPU mesh.  Every argument and result is
numpy or plain Python.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from debiasing_multi_modal_tpu_torch.models import CLIPConfig, create_clip
from debiasing_multi_modal_tpu_torch.parallel.mesh import make_mesh


def _model(cfg_kwargs, state_dict, **kw):
    model = create_clip(CLIPConfig(**cfg_kwargs), device="cpu", **kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    return model


def tp_and_extraction(configs, zs, tokens):
    """For each ``(label, cfg_kwargs, state_dict, quant, pixels, images)``:
    the tensor-parallel towers' features of the float ``pixels`` and the
    ``tokens`` on a (world/2) x 2 mesh, and the data-parallel and dp x tp
    runners' embeddings and predictions of the uint8 ``images``."""
    from debiasing_multi_modal_tpu_torch.extract.runner import ExtractionRunner
    from debiasing_multi_modal_tpu_torch.parallel.tp import shard_variables

    world = dist.get_world_size()
    mesh = make_mesh((world // 2, 2), ("data", "model"), device="cpu")
    data_mesh = make_mesh((world,), ("data",), device="cpu")
    out = {}
    for label, cfg_kwargs, sd, quant, pixels, images in configs:
        model = _model(cfg_kwargs, sd, quant=quant)
        local = shard_variables(model, mesh)
        with torch.no_grad():
            image = local.encode_image(torch.from_numpy(pixels)).numpy()
            text = local.encode_text(torch.from_numpy(tokens)).numpy()
        dp = ExtractionRunner(model, zs, mesh=data_mesh).encode_batch(images)
        tp = ExtractionRunner(model, zs, mesh=mesh, tensor_parallel=True).encode_batch(images)
        out[label] = {"image": image, "text": text, "dp": dp, "tp": tp}
    return out


def extract_cli(argv, bpe_path):
    """``cli/extract_main.py`` with ``argv`` on this rank."""
    from debiasing_multi_modal_tpu_torch.cli import extract_main

    os.environ["CLIP_BPE_PATH"] = bpe_path
    return extract_main.main(extract_main.build_parser().parse_args(argv))


def sequence_parallel(cases):
    """For each ``(label, kind, mesh shape, axis names, batch axis, causal,
    q, k, v, dout)``: the global output and the gradients of ``(out *
    dout).sum()`` with respect to the global q, k, v."""
    from debiasing_multi_modal_tpu_torch.ops.ring_attention import sequence_parallel_attention
    from debiasing_multi_modal_tpu_torch.ops.ulysses_attention import (
        ulysses_sequence_parallel_attention,
    )

    fns = {"ring": sequence_parallel_attention, "ulysses": ulysses_sequence_parallel_attention}
    out = {}
    for label, kind, shape, names, batch_axis, causal, q, k, v, dout in cases:
        mesh = make_mesh(shape, names, device="cpu")
        q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        o = fns[kind](q, k, v, mesh=mesh, axis_name="seq", causal=causal,
                      batch_axis=batch_axis)
        grads = torch.autograd.grad((o * torch.from_numpy(dout)).sum(), (q, k, v))
        out[label] = (o.detach().numpy(), [g.numpy() for g in grads])
    from debiasing_multi_modal_tpu_torch.parallel.multihost import global_batch

    mesh = make_mesh((dist.get_world_size(),), ("seq",), device="cpu")
    rank = dist.get_rank()
    out["global_batch"] = global_batch(np.arange(2 * rank, 2 * rank + 2), mesh,
                                       axis="seq", device="cpu").numpy()
    errors = []
    for fn, shape in ((sequence_parallel_attention, (1, 6, 2, 4)),
                      (ulysses_sequence_parallel_attention, (1, 8, 3, 4)),
                      (sequence_parallel_attention, (1, 8, 2))):
        x = torch.zeros(shape)
        try:
            fn(x, x, x, mesh=mesh, axis_name="seq")
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def _bundle(spec, shard):
    from debiasing_multi_modal_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_dataset
    from debiasing_multi_modal_tpu_torch.train import loop

    meta, table, tc, tg, ts = make_synthetic_dataset(SyntheticSpec(**spec))
    bundle = loop.bundle_from_embedding_table(
        table, {n: meta.take(np.where(meta.split == s)[0])
                for n, s in (("train", 0), ("val", 1), ("test", 2))},
        tc, ts, tg, device="cpu")
    return loop.shard_bundle(bundle, make_mesh(device="cpu")) if shard else bundle


def shard_bundle_runs(spec, runs, results_root):
    """For each ``(label, flags, init)``: ``train_all_epochs`` on the bundle
    sharded over every rank (rank 0 writes ``results_root/label``)."""
    from debiasing_multi_modal_tpu_torch.train import loop
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig

    bundle = _bundle(spec, shard=True)
    out = {}
    for label, flags, init in runs:
        res = loop.train_all_epochs(TrainConfig(**flags), bundle, verbose=False, init=init,
                                    results_dir=os.path.join(results_root, label),
                                    device="cpu")
        out[label] = res
    return out


def seed_mesh_runs(spec, flags, seeds, inits, grid, result_root):
    """The stacked sweep with the rows sharded over every rank: the rows'
    results from ``train_seeds_vmapped`` (from ``inits["rows"]``), a
    ``run_sweep`` grid's CSVs under ``result_root`` (its stacked program's
    rows from ``inits["grid"]``), and the error an uneven split raises."""
    from debiasing_multi_modal_tpu_torch.sweep import runner
    from debiasing_multi_modal_tpu_torch.sweep.vmap_loop import train_seeds_vmapped
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig

    bundle = _bundle(spec, shard=False)
    mesh = make_mesh(device="cpu")
    cfg = TrainConfig(**flags)
    rows = train_seeds_vmapped(cfg, bundle, seeds, mesh=mesh, inits=inits["rows"],
                               device="cpu")
    real = runner.train_seeds_vmapped

    def with_inits(cfg, bundle, seeds, cell_grid=None, **kw):
        return real(cfg, bundle, seeds, cell_grid=cell_grid, inits=inits["grid"], **kw)

    runner.train_seeds_vmapped = with_inits
    try:
        runner.run_sweep(cfg, bundle, seeds, **grid, result_root=result_root, mesh=mesh,
                         device="cpu")
    finally:
        runner.train_seeds_vmapped = real
    try:
        train_seeds_vmapped(cfg, bundle, seeds[:1] * (dist.get_world_size() + 1), mesh=mesh,
                            device="cpu")
        uneven = None
    except ValueError as e:
        uneven = str(e)
    return {"rows": rows, "uneven": uneven}


def isolation():
    """A 2-rank tensor-parallel extraction, seed-mesh sweep and pipelined
    stack on this rank;
    returns the modules of jax or the JAX package that got imported."""
    from debiasing_multi_modal_tpu_torch.extract.runner import ExtractionRunner
    from debiasing_multi_modal_tpu_torch.sweep.runner import run_seeds
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig

    cfg = CLIPConfig(name="tiny-vit", embed_dim=32, image_resolution=32, vision_layers=1,
                     vision_width=128, vision_patch_size=16, transformer_width=64,
                     transformer_heads=2, transformer_layers=1, vocab_size=128)
    model = create_clip(cfg, device="cpu")
    mesh = make_mesh((1, dist.get_world_size()), ("data", "model"), device="cpu")
    images = np.zeros((4, 32, 32, 3), np.uint8)
    emb, _ = ExtractionRunner(model, np.ones((2, 32), np.float32), mesh=mesh,
                              tensor_parallel=True).encode_batch(images)
    assert emb.shape == (4, 32)
    flags = dict(tl_method="adapter", epochs=1, input_dim=16, adapter_feat_dim=8, batch_size=32)
    assert len(run_seeds(TrainConfig(**flags), _bundle(dict(dim=16, n_train=64, n_val=32,
                                                            n_test=32), False),
                         [42, 32], mesh=make_mesh(device="cpu"), device="cpu")) == 2
    from debiasing_multi_modal_tpu_torch.parallel import pp

    from debiasing_multi_modal_tpu_torch.models.layers import Transformer

    stacked, _ = pp.stack_block_params(Transformer(64, 2, 2))
    stages = make_mesh((dist.get_world_size(),), ("stage",), device="cpu")
    x = torch.zeros(2, 8, 64, requires_grad=True)
    pp.pipeline_transformer(stacked, x, mesh=stages, num_heads=2).sum().backward()
    assert x.grad.shape == x.shape
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
                  or m == "debiasing_multi_modal_tpu"
                  or m.startswith("debiasing_multi_modal_tpu."))


def _pp_loss_grads(out, tgt, params, x):
    loss = ((out - tgt) ** 2).mean()
    leaves = list(params.values()) + [x]
    got = torch.autograd.grad(loss, leaves)
    return {k: g.numpy() for k, g in zip(params, got[:-1])}, got[-1].numpy()


def pipeline_cases(sd, x, tgt, cases):
    """For each ``(label, mesh shape, axis names, kwargs, mode)`` the
    pipelined stack of the ``resblocks.*`` state dict ``sd`` on ``x``:
    ``mode`` "fwd" returns the output; "grad" / "remat" also the gradients
    of ``mean((out - tgt)**2)`` for this rank's own layers (its
    ``shard_stage_params``, tensor-parallel slice included) and for ``x``;
    "shard" checks that the rank holds its ``L / n`` layers alone and that
    the run gathers no parameter.  Every rank returns its stage and model
    coordinates beside each result."""
    from debiasing_multi_modal_tpu_torch.parallel import pp
    from debiasing_multi_modal_tpu_torch.parallel.mesh import axis_rank, axis_size

    stacked, n_layers = pp.stack_block_params({k: torch.from_numpy(v) for k, v in sd.items()})
    out = {}
    for label, shape, names, kw, mode in cases:
        mesh = make_mesh(shape, names, device="cpu")
        coords = {axis: axis_rank(mesh, axis) for axis in names}
        xt = torch.from_numpy(x)
        if mode == "fwd":
            with torch.no_grad():
                y = pp.pipeline_transformer(stacked, xt, mesh=mesh, **kw)
            out[label] = {"out": y.numpy(), "coords": coords}
            continue
        local = pp.shard_stage_params(stacked, mesh, stage_axis=kw.get("stage_axis", "stage"),
                                      model_axis=kw.get("model_axis"))
        if mode == "shard":
            calls = []
            real = dist.all_gather, dist.all_gather_into_tensor, dist.batch_isend_irecv

            def count(fn, name):
                def wrapped(*a, **k):
                    calls.append(name)
                    return fn(*a, **k)
                return wrapped

            dist.all_gather = count(real[0], "all_gather")
            dist.all_gather_into_tensor = count(real[1], "all_gather_into_tensor")
            dist.batch_isend_irecv = count(real[2], "batch_isend_irecv")
            try:
                with torch.no_grad():
                    y = pp.pipeline_transformer(local, xt, mesh=mesh, **kw)
            finally:
                dist.all_gather, dist.all_gather_into_tensor, dist.batch_isend_irecv = real
            per = n_layers // axis_size(mesh, "stage")
            stage = coords["stage"]
            out[label] = {"out": y.numpy(), "coords": coords,
                          "local_layers": {k: int(v.shape[0]) for k, v in local.items()},
                          "local_equal": all(
                              torch.equal(v, stacked[k][stage * per:(stage + 1) * per])
                              for k, v in local.items()),
                          "calls": sorted(set(calls)), "n_sends": calls.count("batch_isend_irecv")}
            continue
        params = {k: v.requires_grad_() for k, v in local.items()}
        xg = xt.clone().requires_grad_()
        y = pp.pipeline_transformer(local, xg, mesh=mesh, remat=(mode == "remat"), **kw)
        grads, gx = _pp_loss_grads(y, torch.from_numpy(tgt), params, xg)
        out[label] = {"out": y.detach().numpy(), "grads": grads, "x_grad": gx, "coords": coords}
    return out


def pipeline_errors(sd, x, cases):
    """For each ``(mesh shape, axis names, kwargs)``: the message of the
    ``ValueError`` ``pipeline_transformer`` raises (before any collective)."""
    from debiasing_multi_modal_tpu_torch.parallel import pp

    stacked, _ = pp.stack_block_params({k: torch.from_numpy(v) for k, v in sd.items()})
    out = []
    for shape, names, kw in cases:
        mesh = make_mesh(shape, names, device="cpu")
        kw = dict(kw)
        layers = kw.pop("layers", None)
        st = stacked if layers is None else {k: v[:layers] for k, v in stacked.items()}
        xs = torch.from_numpy(x)[:, :kw.pop("seq_len")] if "seq_len" in kw else torch.from_numpy(x)
        try:
            pp.pipeline_transformer(st, xs, mesh=mesh, **kw)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def pipelined_encode_cases(cfg_kwargs, sd, images, ids, cases):
    """For each ``(label, mesh shape, axis names, dtype name, kwargs)``: the
    pipelined ViT and text encodes of a CLIP built from ``sd`` beside the
    model's own ``encode_image`` / ``encode_text``, and the ViT encode from
    a pre-stacked ``stacked=``."""
    from debiasing_multi_modal_tpu_torch.parallel import pp

    out = {}
    for label, shape, names, dtype, kw in cases:
        model = create_clip(CLIPConfig(**cfg_kwargs), dtype=getattr(torch, dtype), device="cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        mesh = make_mesh(shape, names, device="cpu")
        imgs, toks = torch.from_numpy(images), torch.from_numpy(ids)
        with torch.no_grad():
            vit = pp.pipelined_vit_encode(model, None, imgs, mesh=mesh, **kw)
            text = pp.pipelined_text_encode(model, None, toks, mesh=mesh, **kw)
            pre, _ = pp.stack_block_params(model.visual.transformer)
            vit_pre = pp.pipelined_vit_encode(model, sd, imgs, mesh=mesh, stacked=pre, **kw)
            out[label] = {"vit": vit.float().numpy(), "text": text.float().numpy(),
                          "vit_pre": vit_pre.float().numpy(), "dtype": str(vit.dtype),
                          "ref_vit": model.encode_image(imgs).float().numpy(),
                          "ref_text": model.encode_text(toks).float().numpy()}
    return out


def pipeline_suite(sd, x, tgt, cases, errors=(), towers=None):
    """:func:`pipeline_cases`, then :func:`pipeline_errors` and, with
    ``towers = (cfg_kwargs, sd, images, ids, cases)``,
    :func:`pipelined_encode_cases`, in one launch."""
    import time

    t0 = time.perf_counter()
    out = {"cases": pipeline_cases(sd, x, tgt, cases)}
    t1 = time.perf_counter()
    out["errors"] = pipeline_errors(sd, x, errors)
    t2 = time.perf_counter()
    out["towers"] = pipelined_encode_cases(*towers) if towers is not None else None
    out["seconds"] = (t1 - t0, t2 - t1, time.perf_counter() - t2)
    return out
