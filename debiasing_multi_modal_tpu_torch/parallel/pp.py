"""Pipeline parallelism of the CLIP transformer towers (port of
``parallel/pp.py``).

The towers' homogeneous stack (``Transformer.resblocks``, L identical
``ResidualAttentionBlock``s) is stacked into one ``[L, ...]`` tensor per
block parameter (:func:`stack_block_params`, keyed as the port's block state
dict) and split over the ranks of a ``stage`` mesh axis: each stage rank
applies ``L / n_stages`` consecutive layers and never gathers another
stage's parameters (:func:`shard_stage_params` gives a rank its own layers
alone).  The GPipe schedule runs ``M + n_stages - 1`` ticks over M
microbatches: at tick t stage s holds microbatch ``t - s``; stage 0 injects
microbatch t, every stage applies its layers, and every rank sends its
activation one hop around the stage ring (``batch_isend_irecv``, the wrap
from the last stage to stage 0 included, as JAX's ``perm``) and receives
the previous stage's; the last stage records the finished microbatches, and
its output is replicated over the stage group (a broadcast from the last
stage; JAX sums a one-hot buffer, which is the same exact copy).  A stage
skips its layers on the bubble ticks, where it holds no microbatch (JAX
computes them and discards the result), but every rank sends on every tick,
so all ranks issue the same collectives in the same order.

Gradients: the schedule is one ``torch.autograd.Function`` whose backward
runs the ticks in reverse, sending each cotangent one hop the other way, and
differentiates each tick's layers (kept per tick, or recomputed under
``remat``) with ``torch.autograd.grad``.  The autograd engine would prune
and reorder point-to-point nodes differently on different stages; an
explicit reverse schedule keeps every rank's collectives in one order.  The
semantics are JAX's replicated ones: every rank passes the same ``x`` and
parameters and computes the same loss from the replicated output; only the
last stage's copy of the output's cotangent enters the backward (summing
every stage's would scale the gradients by ``n_stages``); the input
gradient is the same on every rank; a rank's layer gradients are the
sequential stack's for its layers (its tensor-parallel slice of them), the
sum over the ``batch_axis`` and ``seq_axis`` groups, whose ranks see other
rows and tokens of the same layers.

Axes compose as in JAX: ``batch_axis`` shards the microbatch rows (the
caller passes and receives the global batch); ``model_axis`` runs a manual
block (:func:`_tp_block`, JAX's ``_tp_block``) with q/k/v and ``c_fc``
column-sharded and ``out_proj`` / ``c_proj`` row-sharded by
``parallel/tp.py``'s rules (one all-reduce, then the bias once) on the
stage's local heads; ``seq_axis`` shards the sequence and runs each block's
attention as ring (default) or Ulysses attention over that group.  Without
``model_axis`` and ``seq_axis`` each layer is the port's
``ResidualAttentionBlock`` run on the layer's slice (its tensors bound to a
parameterless block, :func:`_block`), so its attention is
``ops/attention.py::multi_head_attention``: kernel 1 on the card.  The
manual block keeps JAX's two-pass-variance LayerNorm (:func:`_ln_f32`),
which differs from ``LayerNormF32`` by about 5e-7 in the JAX package too;
the port copies each side.

JAX caches one jitted program per configuration (``_PROGRAM_CACHE``);
eager PyTorch compiles nothing, so there is no counterpart.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from debiasing_multi_modal_tpu_torch.models.layers import (
    MultiHeadAttentionBlock,
    ResidualAttentionBlock,
    quick_gelu,
)
from debiasing_multi_modal_tpu_torch.ops.attention import multi_head_attention
from debiasing_multi_modal_tpu_torch.ops.ring_attention import _rotate, ring_attention
from debiasing_multi_modal_tpu_torch.ops.ulysses_attention import ulysses_attention
from debiasing_multi_modal_tpu_torch.parallel.collectives import (
    copy_to_group,
    gather_from_group,
    reduce_from_group,
    split_to_group,
)
from debiasing_multi_modal_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size
from debiasing_multi_modal_tpu_torch.parallel.tp import _split_dim

_BLOCK_PREFIX = "resblocks."


def stack_block_params(transformer_params, prefix: str = _BLOCK_PREFIX):
    """Stack the per-layer block tensors into ``[L, ...]`` tensors.

    ``transformer_params`` is a port ``Transformer`` (its parameters are
    stacked with their autograd history, so gradients reach them) or its
    state dict (keys ``{prefix}{i}.<name>``).  Returns ``({name: [L, ...]},
    n_layers)`` keyed as one block's state dict."""
    if isinstance(transformer_params, nn.Module):
        transformer_params = dict(transformer_params.named_parameters())
    pattern = re.compile(re.escape(prefix) + r"(\d+)\.(.+)")
    per_layer: Dict[int, Dict[str, Any]] = {}
    for key, value in transformer_params.items():
        m = pattern.fullmatch(key)
        if m:
            per_layer.setdefault(int(m.group(1)), {})[m.group(2)] = value
    if not per_layer:
        raise ValueError(f"no '{prefix}*' blocks in params: {list(transformer_params)}")
    n_layers = max(per_layer) + 1
    if sorted(per_layer) != list(range(n_layers)):
        raise ValueError(f"non-contiguous block indices: {sorted(per_layer)}")
    names = list(per_layer[0])
    stacked = {name: torch.stack([torch.as_tensor(per_layer[i][name])
                                  for i in range(n_layers)])
               for name in names}
    return stacked, n_layers


def _ln_f32(weight: torch.Tensor, bias: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """LayerNorm in f32 with the variance in two passes (JAX ``_ln_f32``,
    epsilon 1e-5), cast back to ``z``'s dtype."""
    zf = z.float()
    mu = zf.mean(-1, keepdim=True)
    var = ((zf - mu) ** 2).mean(-1, keepdim=True)
    y = (zf - mu) * torch.rsqrt(var + 1e-5)
    y = y * weight.float() + bias.float()
    return y.to(z.dtype)


def validate_pp(n_layers: int, n_stages: int, batch: int, microbatches: int) -> None:
    if n_layers % n_stages:
        raise ValueError(f"pipeline stages {n_stages} must divide the {n_layers} layers")
    if microbatches < 1 or batch % microbatches:
        raise ValueError(f"microbatches {microbatches} must divide the batch {batch}")


def _tp_slice(name: str, t: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
    """This model rank's slice of a stacked ``[L', ...]`` block tensor by
    ``parallel/tp.py``'s rules (q | k | v split a third at a time)."""
    dim = _split_dim(name)
    if dim is None or tp == 1:
        return t
    dim += 1  # the stacked layer axis
    if name.endswith(("in_proj_weight", "in_proj_bias")):
        return torch.cat([third.chunk(tp, dim)[rank] for third in t.chunk(3, dim)], dim)
    return t.chunk(tp, dim)[rank]


class StageParams(dict):
    """One rank's block tensors, ``{name: [L / n_stages, ...]}`` (its
    tensor-parallel slice under ``model_axis``), with the stack's
    ``n_layers`` and the axes they were cut for."""

    def __init__(self, tensors, n_layers: int, stage_axis: str, model_axis: Optional[str]):
        super().__init__(tensors)
        self.n_layers, self.stage_axis, self.model_axis = n_layers, stage_axis, model_axis


def _local_params(stacked, n_layers, mesh, stage_axis, model_axis):
    n_stages, stage = axis_size(mesh, stage_axis), axis_rank(mesh, stage_axis)
    tp = 1 if model_axis is None else axis_size(mesh, model_axis)
    rank = 0 if model_axis is None else axis_rank(mesh, model_axis)
    per = n_layers // n_stages
    return {name: _tp_slice(name, t[stage * per:(stage + 1) * per], tp, rank)
            for name, t in stacked.items()}


def shard_stage_params(stacked: Mapping[str, torch.Tensor], mesh, *, stage_axis: str = "stage",
                       model_axis: Optional[str] = None) -> StageParams:
    """This rank's own layers of a :func:`stack_block_params` stack, copied
    out of it (the counterpart of placing the stack with ``P(stage_axis)``):
    after this the rank needs no other stage's tensors.
    :func:`pipeline_transformer` takes the result in place of the stack."""
    n_layers = next(iter(stacked.values())).shape[0]
    n_stages = axis_size(mesh, stage_axis)
    if n_layers % n_stages:
        raise ValueError(f"pipeline stages {n_stages} must divide the {n_layers} layers")
    local = _local_params(stacked, n_layers, mesh, stage_axis, model_axis)
    return StageParams({k: v.detach().clone().requires_grad_(stacked[k].requires_grad)
                        for k, v in local.items()}, n_layers, stage_axis, model_axis)


def _tp_block(p: Mapping[str, torch.Tensor], h: torch.Tensor, *, heads_local: int,
              causal: bool, dtype, attn_impl: str, mgroup, sgroup, seq_impl: str):
    """JAX's manual tensor/sequence-parallel block: column-sharded q/k/v and
    ``c_fc``, row-sharded ``out_proj`` and ``c_proj`` (partial products, one
    all-reduce, then the bias once), local heads; attention over the
    sequence group when the sequence is sharded."""

    def dense(w, b, z):
        return F.linear(z.to(dtype), w.to(dtype)) + b.to(dtype)

    def row_parallel(w, b, z):
        part = F.linear(z.to(dtype), w.to(dtype))
        if mgroup is not None:
            part = reduce_from_group(part, mgroup)
        return part + b.to(dtype)

    def enter(z):  # Megatron's "f": the column-parallel input's gradient is summed
        return z if mgroup is None else copy_to_group(z, mgroup)

    hn = enter(_ln_f32(p["ln_1.weight"], p["ln_1.bias"], h))
    w, b = p["attn.in_proj_weight"], p["attn.in_proj_bias"]
    dl = w.shape[0] // 3
    q, k, v = (dense(w[i * dl:(i + 1) * dl], b[i * dl:(i + 1) * dl], hn) for i in range(3))
    if sgroup is None:
        o = multi_head_attention(q, k, v, heads_local, causal=causal, impl=attn_impl)
    else:
        bsz, sl, _ = q.shape
        qh, kh, vh = (z.reshape(bsz, sl, heads_local, dl // heads_local) for z in (q, k, v))
        attend = ring_attention if seq_impl == "ring" else ulysses_attention
        o = attend(qh, kh, vh, sgroup, causal).reshape(bsz, sl, dl)
    h = h + row_parallel(p["attn.out_proj.weight"], p["attn.out_proj.bias"], o)
    hn = enter(_ln_f32(p["ln_2.weight"], p["ln_2.bias"], h))
    hh = quick_gelu(dense(p["mlp.c_fc.weight"], p["mlp.c_fc.bias"], hn))
    return h + row_parallel(p["mlp.c_proj.weight"], p["mlp.c_proj.bias"], hh)


_BLOCKS: Dict[tuple, tuple] = {}


def _block(width: int, heads: int, causal: bool, dtype, attn_impl: str):
    """A port ``ResidualAttentionBlock`` without parameters of its own (built
    on the meta device once per configuration) and, for each of its
    parameter names, the submodule and attribute a layer's tensor is bound
    to before each call.  Binding is a dozen attribute writes; a
    ``torch.func.functional_call`` per layer and microbatch cost ~0.7 ms of
    host time each, which made the pipelined encode host-bound."""
    key = (width, heads, causal, dtype, attn_impl)
    if key not in _BLOCKS:
        with torch.device("meta"):
            block = ResidualAttentionBlock(width, heads, causal=causal, dtype=dtype,
                                           attn_impl=attn_impl)
        slots = {}
        for name, _ in list(block.named_parameters()):
            path, _, leaf = name.rpartition(".")
            module = block.get_submodule(path)
            del module._parameters[leaf]
            slots[name] = (module, leaf)
        _BLOCKS[key] = (block, slots)
    return _BLOCKS[key]


class _Schedule:
    """The GPipe ticks of one stage rank."""

    def __init__(self, block_fn, names, n_stages: int, stage: int, group, remat: bool):
        self.block_fn, self.names, self.remat = block_fn, list(names), remat
        self.n, self.stage, self.group = n_stages, stage, group

    def run_local(self, params, h):
        n_local = next(iter(params.values())).shape[0]
        for i in range(n_local):
            layer = {name: t[i] for name, t in params.items()}
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(self.block_fn, layer, h, use_reentrant=False)
            else:
                h = self.block_fn(layer, h)
        return h

    def shift(self, t: torch.Tensor, step: int) -> torch.Tensor:
        return _rotate((t,), self.group, step)[0] if self.n > 1 else t

    def forward(self, x_mb, params, keep: bool):
        """Every tick; returns the last stage's outputs (zeros elsewhere)
        and, with ``keep``, each computing tick's (input, output) graph."""
        m, s, n = x_mb.shape[0], self.stage, self.n
        carry = zeros = torch.zeros_like(x_mb[0])
        outs, saved = [], {}
        for t in range(m + n - 1):
            mb = t - s
            if 0 <= mb < m:
                h = x_mb[mb] if s == 0 else carry
                if keep:
                    h = h.detach().requires_grad_()
                    with torch.enable_grad():
                        y = self.run_local(params, h)
                    saved[t] = (h, y)
                    y = y.detach()
                else:
                    y = self.run_local(params, h)
                if s == n - 1:
                    outs.append(y)
            else:
                y = zeros  # a bubble tick: nothing to compute, the send still happens
            carry = self.shift(y, 1)
        out = torch.stack(outs) if s == n - 1 else torch.zeros(
            (m,) + tuple(carry.shape), dtype=carry.dtype, device=carry.device)
        if n > 1:
            dist.broadcast(out, dist.get_global_rank(self.group, n - 1), group=self.group)
        return out, saved


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, grad_groups, x_mb, *params):
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        out, saved = sched.forward(x_mb, dict(zip(sched.names, leaves)), keep=True)
        ctx.sched, ctx.grad_groups, ctx.saved_ticks, ctx.leaves = sched, grad_groups, saved, leaves
        ctx.m = x_mb.shape[0]
        return out

    @staticmethod
    def backward(ctx, g_out):
        sched, saved, leaves = ctx.sched, ctx.saved_ticks, ctx.leaves
        m, s, n = ctx.m, sched.stage, sched.n
        want = [i for i, p in enumerate(leaves) if p.requires_grad]
        grads = [None] * len(leaves)
        g_x = torch.zeros_like(g_out)
        zeros = torch.zeros_like(g_out[0])
        g_carry = zeros
        for t in reversed(range(m + n - 1)):
            g_y = sched.shift(g_carry, -1)  # the next stage's cotangent of our y_t
            mb = t - s
            if t not in saved:
                g_carry = zeros
                continue
            if s == n - 1:  # only the last stage's copy of the replicated output
                g_y = g_y + g_out[mb]
            h, y = saved.pop(t)
            got = torch.autograd.grad(y, [h] + [leaves[i] for i in want], g_y,
                                      allow_unused=True)
            for i, g in zip(want, got[1:]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
            if s == 0:
                g_x[mb] = got[0]
                g_carry = zeros
            else:
                g_carry = got[0]
        grads = [g if g is not None or i not in want else torch.zeros_like(leaves[i])
                 for i, g in enumerate(grads)]
        if want:  # the rows and tokens of other ranks trained the same layers
            flat = torch.cat([grads[i].reshape(-1).float() for i in want])
            for group in ctx.grad_groups:
                dist.all_reduce(flat, group=group)
            for i, chunk in zip(want, flat.split([leaves[i].numel() for i in want])):
                grads[i] = chunk.view_as(leaves[i]).to(leaves[i].dtype)
        if ctx.needs_input_grad[2]:
            if n > 1:  # stage 0 holds it; replicate over the stage group
                gx = g_x.float()
                dist.all_reduce(gx, group=sched.group)
                g_x = gx.to(g_x.dtype)
        else:
            g_x = None
        return (None, None, g_x, *grads)


def pipeline_transformer(
    stacked_params,
    x: torch.Tensor,
    *,
    mesh,
    num_heads: int,
    causal: bool = False,
    microbatches: int = 1,
    stage_axis: str = "stage",
    batch_axis: Optional[str] = None,
    model_axis: Optional[str] = None,
    seq_axis: Optional[str] = None,
    dtype=torch.float32,
    param_dtype=torch.float32,
    attn_impl: str = "auto",
    seq_impl: str = "ring",
    remat: bool = False,
) -> torch.Tensor:
    """Run the stacked transformer over ``x [B, S, D]`` pipeline-parallel.

    ``stacked_params`` is :func:`stack_block_params`'s stack (every layer;
    this rank takes its own) or :func:`shard_stage_params`'s (this rank's
    layers alone).  Every rank passes the same ``x`` and gets the stack's
    whole output; differentiable in ``x`` and the parameters.  The axes and
    their gradients: the module docstring."""
    n_stages = axis_size(mesh, stage_axis)
    if isinstance(stacked_params, StageParams):
        if (stacked_params.stage_axis, stacked_params.model_axis) != (stage_axis, model_axis):
            raise ValueError(
                f"stage params cut for axes ({stacked_params.stage_axis!r}, "
                f"{stacked_params.model_axis!r}), run with ({stage_axis!r}, {model_axis!r})")
        n_layers = stacked_params.n_layers
    else:
        n_layers = next(iter(stacked_params.values())).shape[0]
    validate_pp(n_layers, n_stages, x.shape[0], microbatches)
    if batch_axis is not None and (x.shape[0] // microbatches) % axis_size(mesh, batch_axis):
        raise ValueError(
            f"microbatch rows {x.shape[0] // microbatches} must be divisible "
            f"by the '{batch_axis}' axis size {axis_size(mesh, batch_axis)}"
        )
    tp = 1 if model_axis is None else axis_size(mesh, model_axis)
    if num_heads % tp:
        raise ValueError(f"model axis size {tp} must divide the {num_heads} attention heads")
    sp = 1 if seq_axis is None else axis_size(mesh, seq_axis)
    if x.shape[1] % sp:
        raise ValueError(
            f"sequence {x.shape[1]} must be divisible by the '{seq_axis}' axis size {sp}")
    if seq_impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown seq_impl {seq_impl!r}; known: ring, ulysses")
    if seq_impl == "ulysses" and (num_heads // tp) % sp:
        raise ValueError(
            f"ulysses needs local heads {num_heads // tp} divisible by the "
            f"'{seq_axis}' axis size {sp}"
        )

    if isinstance(stacked_params, StageParams):
        local = dict(stacked_params)
    else:
        local = _local_params(stacked_params, n_layers, mesh, stage_axis, model_axis)
    local = {k: v.to(param_dtype) if v.is_floating_point() else v for k, v in local.items()}
    mgroup = None if model_axis is None else axis_group(mesh, model_axis)
    sgroup = None if seq_axis is None else axis_group(mesh, seq_axis)
    dgroup = None if batch_axis is None else axis_group(mesh, batch_axis)
    if model_axis is None and seq_axis is None:
        block, slots = _block(x.shape[-1], num_heads, causal, dtype, attn_impl)

        def block_fn(p, h):
            for name, (module, leaf) in slots.items():
                setattr(module, leaf, p[name])
            return block(h)
    else:
        def block_fn(p, h):
            return _tp_block(p, h, heads_local=num_heads // tp, causal=causal, dtype=dtype,
                             attn_impl=attn_impl, mgroup=mgroup, sgroup=sgroup,
                             seq_impl=seq_impl)

    sched = _Schedule(block_fn, local, n_stages, axis_rank(mesh, stage_axis),
                      axis_group(mesh, stage_axis), remat)
    m = microbatches
    # the blocks' output dtype, so that every tick sends one dtype
    x = x.to(torch.promote_types(x.dtype, dtype))
    x_mb = x.reshape(m, x.shape[0] // m, *x.shape[1:])
    if dgroup is not None:
        x_mb = split_to_group(x_mb, dgroup, 1)
    if sgroup is not None:
        x_mb = split_to_group(x_mb, sgroup, 2)
    params = list(local.values())
    if torch.is_grad_enabled() and (x_mb.requires_grad or any(p.requires_grad for p in params)):
        grad_groups = [g for g in (dgroup, sgroup)
                       if g is not None and dist.get_world_size(g) > 1]
        out = _Pipeline.apply(sched, grad_groups, x_mb, *params)
    else:
        out, _ = sched.forward(x_mb, local, keep=False)
    if sgroup is not None:
        out = gather_from_group(out, sgroup, 2)
    if dgroup is not None:
        out = gather_from_group(out, dgroup, 1)
    return out.reshape(x.shape[0], *out.shape[2:])


# ------------------------------------------------------------ tower encodes --


def _check_tower_supported(clip_model, pp_kwargs) -> None:
    """The pipelined encodes run the plain block math; a model built with
    ``quant`` or ``fuse_qkv`` holds the same parameters, so without this
    guard it would silently run unquantized, unfused math."""
    blocks = [m for m in clip_model.modules() if isinstance(m, MultiHeadAttentionBlock)]
    quant = next((b.quant for b in blocks if b.quant != "none"), "none")
    if quant != "none":
        raise ValueError(
            f"pipelined encodes do not support quant={quant!r} towers "
            "(the stacked block math is the default-precision path)"
        )
    if any(b.fuse_qkv for b in blocks):
        raise ValueError(
            "pipelined encodes do not support fuse_qkv towers "
            "(the stacked block math uses the unfused projections)"
        )
    clash = {"num_heads", "dtype", "causal"} & set(pp_kwargs)
    if clash:
        raise TypeError(
            f"{sorted(clash)} are fixed by the tower encode (taken from the "
            "model/config); remove them from the keyword arguments"
        )
    # the model's attention dispatch unless the caller overrides it
    pp_kwargs.setdefault("attn_impl", blocks[0].attn_impl if blocks else "auto")


def _tensors(clip_model, variables):
    """The model's own parameters (with their autograd history), or a
    state dict in the OpenAI layout on the model's device."""
    if variables is None:
        return dict(clip_model.named_parameters())
    device = next(clip_model.parameters()).device
    return {k: torch.as_tensor(v).to(device) for k, v in variables.items()}


def _stack_of(sd, prefix, stacked):
    if stacked is not None:
        return stacked
    return stack_block_params({k[len(prefix):]: v for k, v in sd.items()
                               if k.startswith(prefix)})[0]


def pipelined_vit_encode(clip_model, variables, images: torch.Tensor, *, mesh,
                         stacked=None, **pp_kwargs) -> torch.Tensor:
    """The ViT tower's encode with its stack pipelined: patch GEMM, class
    token, positional embedding and ``ln_pre`` (the tower's own steps,
    ``models/vit.py``), then :func:`pipeline_transformer` (any of its axes),
    then ``ln_post`` and the class token's projection.  ``variables`` is
    None (the model's parameters) or an OpenAI-layout state dict;
    ``stacked`` a pre-stacked (or :func:`shard_stage_params`) stack of the
    visual blocks.  ``images``: CLIP-normalized ``[N, H, W, 3]``."""
    _check_tower_supported(clip_model, pp_kwargs)
    cfg = clip_model.config
    dtype = cfg.dtype
    sd = _tensors(clip_model, variables)
    x = images.to(dtype)
    n, h, w, c = x.shape
    p = cfg.vision_patch_size
    gh, gw = h // p, w // p
    patches = x.reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(n, gh * gw, p * p * c)
    conv = sd["visual.conv1.weight"]
    kernel = conv.permute(2, 3, 1, 0).reshape(-1, conv.shape[0])
    tokens = patches @ kernel.to(dtype)
    width = tokens.shape[-1]
    cls = sd["visual.class_embedding"].to(dtype).expand(n, 1, width)
    tokens = torch.cat([cls, tokens], dim=1)
    tokens = tokens + sd["visual.positional_embedding"].to(dtype)
    tokens = _ln_f32(sd["visual.ln_pre.weight"], sd["visual.ln_pre.bias"], tokens)
    tokens = pipeline_transformer(
        _stack_of(sd, "visual.transformer.", stacked), tokens, mesh=mesh,
        num_heads=cfg.vision_heads, dtype=dtype, **pp_kwargs,
    )
    cls_out = _ln_f32(sd["visual.ln_post.weight"], sd["visual.ln_post.bias"], tokens[:, 0])
    return cls_out @ sd["visual.proj"].to(cls_out.dtype)


def pipelined_text_encode(clip_model, variables, token_ids: torch.Tensor, *, mesh,
                          stacked=None, **pp_kwargs) -> torch.Tensor:
    """The text tower's encode with its causal stack pipelined: token and
    positional embeddings, :func:`pipeline_transformer`, ``ln_final``, the
    feature at the EOT token (the highest id) and the text projection."""
    _check_tower_supported(clip_model, pp_kwargs)
    cfg = clip_model.config
    dtype = cfg.dtype
    sd = _tensors(clip_model, variables)
    token_ids = token_ids.long()
    x = F.embedding(token_ids, sd["token_embedding.weight"]).to(dtype)
    x = x + sd["positional_embedding"].to(dtype)
    x = pipeline_transformer(
        _stack_of(sd, "transformer.", stacked), x, mesh=mesh,
        num_heads=cfg.transformer_heads, causal=True, dtype=dtype, **pp_kwargs,
    )
    x = _ln_f32(sd["ln_final.weight"], sd["ln_final.bias"], x)
    feats = x[torch.arange(x.shape[0], device=x.device), token_ids.argmax(dim=-1)]
    return feats @ sd["text_projection"].to(feats.dtype)
