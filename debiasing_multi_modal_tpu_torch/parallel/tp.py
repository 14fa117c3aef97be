"""Tensor parallelism of the CLIP towers (port of ``parallel/tp.py``).

Megatron's sharding of every transformer block of the ViT and text towers
and of the ModifiedResNet's attention pool, by the JAX package's rules
(``parallel/tp.py:39-75``), over a mesh axis (``model``):

- ``q_proj``, ``k_proj``, ``v_proj`` and ``c_fc`` are column-parallel: the
  weight is split on its output features (whole attention heads), the bias
  alike.  The port's attention blocks keep q, k and v stacked in
  ``in_proj_weight [3D, D]`` (OpenAI's layout), so each third is split.
- ``out_proj`` and ``c_proj`` under ``attn``, ``mlp`` or ``attnpool`` are
  row-parallel: the weight is split on its input features, the bias
  replicated.
- Everything else is replicated, the ResNet convolutions and the ViT's bare
  ``proj`` included.

Where XLA inserts the collectives from the specs, here
:func:`shard_variables` builds each rank's local module: every attention
block and pool holds its ``H/tp`` heads (``D/tp`` width) and runs them
through ``ops/attention.py::multi_head_attention`` (kernel 1 per shard on
the card), every MLP its ``4D/tp`` hidden units, and each row-parallel
layer is a :class:`RowParallelLinear` that sums the ranks' partial products
(Megatron's "g", an all-reduce).  Megatron's "f" (identity forward,
all-reduce backward) enters each sharded block through a forward pre-hook,
so gradients through the towers are the unsharded ones.

Under ``quant="int8"`` / ``"int8_pallas"`` a column-parallel Dense
quantizes its replicated input as before and its local columns at their own
scales.  A row-parallel one takes the row and column scales over the whole
contraction (an all-reduce max of the local maxima, as XLA inserts for the
sharded ``amax``), so its integer products are the unsharded ones: under
``int8`` the int32 partial products are summed exactly and dequantized
once; under ``int8_pallas`` each shard runs kernel 7 (its f32 epilogue at
the shard) and the f32 partials are summed.  The replicated bias is added
once, after the sum (Megatron's form, so its gradient is the same on every
rank); under ``int8_pallas``, where no gradient flows, rank 0's kernel 7
adds it in its fused epilogue, as the unsharded layer's does.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from debiasing_multi_modal_tpu_torch.models.layers import (
    MLPBlock,
    MultiHeadAttentionBlock,
)
from debiasing_multi_modal_tpu_torch.models.resnet import AttentionPool2d
from debiasing_multi_modal_tpu_torch.ops.quant import (
    Int8Dense,
    _int_product,
    int8_matmul_padded,
    int8_scale,
    quantize_with_scale,
)
from debiasing_multi_modal_tpu_torch.ops.quant_gemm import dequantize
from debiasing_multi_modal_tpu_torch.parallel.collectives import (
    all_reduce_max,
    copy_to_group,
    reduce_from_group,
)
from debiasing_multi_modal_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

# parents whose Linear weights are column-parallel (output-feature split)
_COLUMN_PARENTS = ("q_proj", "k_proj", "v_proj", "c_fc")
# parents that are row-parallel (input-feature split) under these grandparents
_ROW_PARENTS = ("out_proj", "c_proj")
_ROW_GRANDPARENTS = ("attn", "mlp", "attnpool")


def _split_dim(name: str) -> Optional[int]:
    """The dim a parameter is split on (torch ``[out, in]`` weights), or
    None when it is replicated."""
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    grand = parts[-3] if len(parts) >= 3 else ""
    if leaf in ("in_proj_weight", "in_proj_bias"):
        return 0  # q | k | v stacked: each third split on its output features
    if parent in _COLUMN_PARENTS and leaf in ("weight", "bias"):
        return 0
    if parent in _ROW_PARENTS and grand in _ROW_GRANDPARENTS and leaf == "weight":
        return 1
    return None


def tp_specs(state: Mapping[str, object]) -> Dict[str, Optional[int]]:
    """``{name: split dim or None}`` for every entry of a CLIP (or tower)
    state dict, or of a module's (its parameters and buffers)."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    return {name: _split_dim(name) for name in state}


def sharded_param_count(state: Mapping[str, object]) -> int:
    """Number of tensors NOT replicated: proof that the towers really are
    sharded."""
    return sum(dim is not None for dim in tp_specs(state).values())


def validate_tp(config, tp: int) -> None:
    """``tp`` must divide every head count (and thus every sharded feature
    dim) so column-parallel splits land on whole attention heads."""
    if tp <= 1:
        return
    heads = {"text": config.transformer_heads, "vision": config.vision_heads}
    for tower, h in heads.items():
        if h % tp:
            raise ValueError(
                f"tensor-parallel degree {tp} does not divide the {tower} "
                f"tower's {h} attention heads"
            )


class RowParallelLinear(nn.Module):
    """A Linear whose input features are split over ``group``: ``weight
    [out, in/tp]`` (this rank's columns), ``bias [out]`` replicated.  The
    output is the sum of every rank's partial product plus the bias.
    ``impl`` is None (the activation dtype's GEMM) or the W8A8 impl of the
    layer it replaces ("xla": exact int32 partial sums; "pallas": kernel 7
    per shard)."""

    def __init__(self, layer: nn.Linear, cols: slice, group, rank: int, dtype,
                 impl: Optional[str] = None):
        super().__init__()
        self.weight = nn.Parameter(layer.weight.detach()[:, cols].clone(),
                                   requires_grad=layer.weight.requires_grad)
        self.bias = nn.Parameter(layer.bias.detach().clone(),
                                 requires_grad=layer.bias.requires_grad)
        self.group, self.rank, self.dtype, self.impl = group, rank, dtype, impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl is None:
            partial = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
            return reduce_from_group(partial, self.group) + self.bias.to(self.dtype)
        x32 = x.float()
        kernel = self.weight.t().float()  # [in/tp, out]
        sx = int8_scale(all_reduce_max(x32.abs().amax(dim=-1, keepdim=True), self.group))
        sk = int8_scale(all_reduce_max(kernel.abs().amax(dim=0), self.group))
        lead, n = x.shape[:-1], kernel.shape[1]
        qx = quantize_with_scale(x32, sx).reshape(-1, x.shape[-1])
        qk = quantize_with_scale(kernel, sk)
        sx = sx.reshape(-1, 1)
        if self.impl == "xla":
            acc = reduce_from_group(_int_product(qx, qk), self.group)  # exact int32 sum
            out = dequantize(acc, sx, sk, self.bias.float(), fused=False)
        else:
            bias = self.bias.float() if self.rank == 0 else None
            out = int8_matmul_padded(qx, qk, sx, sk, bias, torch.float32)
            out = reduce_from_group(out, self.group)
        return out.reshape(*lead, n).to(self.dtype)


def _narrowed(layer: nn.Linear, rows) -> nn.Linear:
    """A Linear of ``layer``'s class holding its output rows ``rows``."""
    w, b = layer.weight.detach()[rows], layer.bias.detach()[rows]
    if isinstance(layer, Int8Dense):
        out = Int8Dense(w.shape[1], w.shape[0], out_dtype=layer.out_dtype, impl=layer.impl)
    else:
        out = nn.Linear(w.shape[1], w.shape[0])
    out = out.to(device=w.device, dtype=w.dtype)
    with torch.no_grad():
        out.weight.copy_(w)
        out.bias.copy_(b)
    return out.requires_grad_(layer.weight.requires_grad)


def _row_parallel(layer: nn.Linear, cols: slice, group, rank: int, dtype) -> RowParallelLinear:
    impl = layer.impl if isinstance(layer, Int8Dense) else None
    return RowParallelLinear(layer, cols, group, rank, dtype, impl)


def _block(width: int, tp: int, rank: int) -> slice:
    per = width // tp
    return slice(rank * per, (rank + 1) * per)


def _copy_hook(group):
    def hook(module, args):
        return (copy_to_group(args[0], group),) + tuple(args[1:])
    return hook


def shard_variables(model: nn.Module, mesh, axis: str = "model") -> nn.Module:
    """Rank-local tensor-parallel copy of a CLIP (or tower) ``model`` on
    ``mesh``'s ``axis``; the model itself is left as it is.  Raises the JAX
    package's ``ValueError`` when the axis size does not divide the heads."""
    tp, rank, group = axis_size(mesh, axis), axis_rank(mesh, axis), axis_group(mesh, axis)
    config = getattr(model, "config", None)
    if config is not None:
        validate_tp(config, tp)
    local = copy.deepcopy(model)
    for module in list(local.modules()):
        if isinstance(module, MultiHeadAttentionBlock):
            width = module.in_proj_weight.shape[1]
            if module.num_heads % tp:
                raise ValueError(f"tensor-parallel degree {tp} does not divide "
                                 f"{module.num_heads} attention heads")
            cols = _block(width, tp, rank)
            rows = torch.cat([torch.arange(width)[cols] + i * width for i in range(3)])
            rows = rows.to(module.in_proj_weight.device)
            grad = module.in_proj_weight.requires_grad
            module.in_proj_weight = nn.Parameter(module.in_proj_weight.detach()[rows].clone(),
                                                 requires_grad=grad)
            module.in_proj_bias = nn.Parameter(module.in_proj_bias.detach()[rows].clone(),
                                               requires_grad=grad)
            module.num_heads //= tp
            module.out_proj = _row_parallel(module.out_proj, cols, group, rank, module.dtype)
            module.register_forward_pre_hook(_copy_hook(group))
        elif isinstance(module, MLPBlock):
            cols = _block(module.c_fc.out_features, tp, rank)
            module.c_fc = _narrowed(module.c_fc, cols)
            module.c_proj = _row_parallel(module.c_proj, cols, group, rank, module.dtype)
            module.register_forward_pre_hook(_copy_hook(group))
        elif isinstance(module, AttentionPool2d):
            if module.num_heads % tp:
                raise ValueError(f"tensor-parallel degree {tp} does not divide "
                                 f"{module.num_heads} attention heads")
            cols = _block(module.q_proj.out_features, tp, rank)
            for name in ("q_proj", "k_proj", "v_proj"):
                setattr(module, name, _narrowed(getattr(module, name), cols))
            module.num_heads //= tp
            module.c_proj = _row_parallel(module.c_proj, cols, group, rank, module.dtype)
            module.register_forward_pre_hook(_copy_hook(group))
    return local
