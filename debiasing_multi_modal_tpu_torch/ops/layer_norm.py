"""The towers' f32 LayerNorm as one pass on the card (``csrc/layer_norm.cu``).

:func:`layer_norm` computes ``models/layers.py::LayerNormF32``: each row's
mean and biased variance in f32, ``(x - mean) * rstd * weight + bias`` in
f32 with the f32 parameters, rounded once to x's dtype.  On a CPU tensor it
runs the plain version, :func:`layer_norm_reference` (widen to f32,
``F.layer_norm``, narrow: what the layer always ran there); on a CUDA tensor
it launches the kernel, counted in ``layer_norm.launches``, or raises where
:func:`supported` does not hold.  There is no fall back from one to the
other.

The kernel replaces no TPU kernel: the JAX package leaves its
``LayerNormF32`` to XLA, which fuses the widening, the moments, the
normalization and the narrowing with the ops around them.  Eager PyTorch ran
them as four passes over device memory; the kernel reads each row once and
writes it once, which is what bounds it (bytes).  The CUDA source says how
its design reaches that bound.

The kernel takes bf16 and f32 rows whose width is a multiple of 8, at most
:data:`MAX_WIDTH` (instances at the CLIP widths, :data:`WIDTHS`, and a
generic one), f32 ``weight`` and ``bias`` of that width, and rows evenly
spaced in memory (:func:`row_stride`), so that ``ln_post``'s ``x[:, 0]``
view is read in place; x's base pointer and row stride are 16-byte
multiples (16-byte vector loads).  ``weight`` and ``bias`` may lie at any
offset (a warp reads them once, by scalar loads): a state dict of views into
one flat buffer loads as it is.

Gradients: where grad is on and an input requires it, the launch runs
inside :class:`_PlainVJP`, whose backward is the VJP of the plain version
recomputed from the saved inputs, as kernels 1-3 do
(``ops/short_attention.py``).  Under ``torch.inference_mode()``, or with no
input requiring grad, the wrapper launches and saves nothing.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from debiasing_multi_modal_tpu_torch.ops import cuda_build

WIDTHS = (512, 640, 768, 1024)  # the instantiated widths: every tower of models/config.py
MAX_WIDTH = 2048  # the generic instance's largest width
_INT_LIMIT = 2 ** 30  # rows and the row stride ride C ints
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """Plain PyTorch version: LayerNorm of x widened to f32, narrowed back."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps).to(x.dtype)


def row_stride(x: torch.Tensor) -> Optional[int]:
    """Elements between consecutive rows of x's last axis, where that axis
    is contiguous and the leading axes flatten to evenly spaced rows (a
    contiguous tensor, or a view such as ``x[:, 0]``); else None."""
    if x.ndim == 0 or (x.shape[-1] > 1 and x.stride(-1) != 1):
        return None
    stride = expected = None
    for n, s in reversed(list(zip(x.shape[:-1], x.stride()[:-1]))):
        if n == 1:
            continue
        if stride is None:
            stride = expected = s
        if s != expected:
            return None
        expected = s * n
    return x.shape[-1] if stride is None else stride


def supported(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> bool:
    """Whether the kernel takes this call: bf16 or f32 rows of a width that
    is a multiple of 8 up to :data:`MAX_WIDTH`, evenly spaced at a 16-byte
    multiple from a 16-byte aligned base, and contiguous f32 ``weight`` and
    ``bias`` of that width on x's device."""
    if x.dtype not in _DTYPE_CODES or x.ndim == 0:
        return False
    d = x.shape[-1]
    if d % 8 or not 8 <= d <= MAX_WIDTH or x.numel() // d > _INT_LIMIT:
        return False
    for p in (weight, bias):
        if (p is None or p.dtype != torch.float32 or tuple(p.shape) != (d,)
                or not p.is_contiguous() or p.device != x.device):
            return False
    stride = row_stride(x)
    return (stride is not None and stride <= _INT_LIMIT
            and stride * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0)


def _launch(x, weight, bias, eps):
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    d = x.shape[-1]
    rows = x.numel() // d
    if rows:
        cuda_build.launch("layer_norm", "layer_norm_forward", (x, weight, bias, out),
                          (rows, d, row_stride(x), _DTYPE_CODES[x.dtype]), x.device,
                          floats=(eps,))
        layer_norm.launches += 1
    return out


class _PlainVJP(torch.autograd.Function):
    """The kernel's output, with the VJP of :func:`layer_norm_reference` as
    the backward (recomputed from the saved inputs)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return _launch(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = layer_norm_reference(*leaves, ctx.eps)
            grads = torch.autograd.grad(out, leaves, grad)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)


def _refuse(x, weight, bias):
    shapes = [None if p is None else (tuple(p.shape), p.dtype) for p in (weight, bias)]
    raise ValueError(
        f"the CUDA layer_norm kernel does not take {tuple(x.shape)} {x.dtype} with strides "
        f"{x.stride()} and weight, bias {shapes} (see supported())"
    )


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over x's last axis with f32 statistics and f32 ``weight``,
    ``bias``; the result has x's shape (contiguous) and dtype.

    CPU tensors take :func:`layer_norm_reference`.  CUDA tensors launch the
    kernel (counted in ``layer_norm.launches``) where :func:`supported`
    holds, else raise."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cuda or cpu, not {x.device}")
    if not supported(x, weight, bias):
        _refuse(x, weight, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        return _PlainVJP.apply(x, weight, bias, eps)
    return _launch(x, weight, bias, eps)


layer_norm.launches = 0
