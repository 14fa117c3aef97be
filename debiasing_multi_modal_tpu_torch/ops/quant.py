"""Dynamic int8 (W8A8) Dense layers: the port of ``ops/quant.py``.

Scheme, as in the JAX package (standard dynamic W8A8, no calibration):

- weights: symmetric per-output-channel scales, ``s_w[n] = max|K[:, n]| / 127``;
- activations: symmetric per-row scales computed on the fly,
  ``s_x[row] = max|x[row, :]| / 127``;
- rounding: f32 ``x / scale``, then round half to even; the scale floor is
  the f32 ``tiny``, so all-zero rows and columns quantize to zeros;
- GEMM: int8 x int8 -> exact int32;
- epilogue: ``(acc * s_x) * s_w + bias`` in f32, cast to the output dtype;
  the ``xla`` impl rounds the bias add on its own and kernel 7 fuses it with
  the last multiply, as the JAX package's two impls do
  (:func:`~debiasing_multi_modal_tpu_torch.ops.quant_gemm.dequantize`).

The weights are quantized per call, as in the JAX package's ``int8_dense``.

:func:`int8_dense` has two impls, by the model-level ``quant`` mode
(``models/layers.py::quant_impl``):

- ``"xla"`` (``quant="int8"``): the plain integer product, as the JAX
  package leaves an integer ``dot_general`` to XLA outside any Pallas
  kernel.  On a CUDA tensor that is ``torch._int_mm`` (a library int8 GEMM,
  outside any kernel of this port), which raises on shapes it refuses
  (M <= 16, K or N not a multiple of 8; every ViT Dense of an image batch
  has M >= 50 and CLIP widths that are multiples of 8); on the CPU an int32
  matmul.  It never runs kernel 7.
- ``"pallas"`` (``quant="int8_pallas"``): kernel 7,
  :func:`~debiasing_multi_modal_tpu_torch.ops.quant_gemm.int8_matmul`.

Both compute the same exact integer product.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from debiasing_multi_modal_tpu_torch.ops.quant_gemm import dequantize, int8_matmul

# Smallest normal f32: guards all-zero rows and columns without perturbing
# any real scale.
_SCALE_FLOOR = torch.finfo(torch.float32).tiny


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """The symmetric int8 scale of an f32 absolute maximum."""
    return (amax / 127.0).clamp_min(_SCALE_FLOOR)


def quantize_with_scale(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round half to even of ``x32 / scale`` into int8."""
    return torch.round(x32 / scale).to(torch.int8)


def quantize_rows_int8(x: torch.Tensor):
    """Symmetric per-row int8 quantization over the last axis: ``(q,
    scale)`` with ``q`` int8 of x's shape and ``scale`` f32 of
    ``x.shape[:-1] + (1,)``, ``q * scale ~= x``."""
    x32 = x.float()
    scale = int8_scale(x32.abs().amax(dim=-1, keepdim=True))
    return quantize_with_scale(x32, scale), scale


def quantize_cols_int8(kernel: torch.Tensor):
    """Symmetric per-output-channel int8 quantization of a ``[K, N]`` weight:
    ``(q [K, N] int8, scale [N] f32)``.  ``q`` keeps ``kernel``'s strides, so
    the transposed view of a Linear weight quantizes into the transposed view
    of a K-contiguous ``[N, K]`` tensor."""
    k32 = kernel.float()
    scale = int8_scale(k32.abs().amax(dim=0))
    return quantize_with_scale(k32, scale), scale


def _int_product(qx: torch.Tensor, qk: torch.Tensor) -> torch.Tensor:
    """The exact integer ``qx @ qk`` outside any kernel of the port."""
    if qx.device.type == "cpu":
        return qx.to(torch.int32) @ qk.to(torch.int32)
    return torch._int_mm(qx, qk)


def int8_matmul_padded(qx, qk, sx, sk, bias, out_dtype) -> torch.Tensor:
    """Kernel 7 at any N: a weight whose N is not a multiple of 128 (a
    tensor-parallel shard, e.g. ViT-B/32's q/k/v at tp = 4, N = 192) is
    padded here with zero columns (scale 1, bias 0), as the kernel's
    contract asks of its caller, and the padded columns are dropped."""
    n = qk.shape[1]
    pad = -n % 128
    if not pad:
        return int8_matmul(qx, qk, sx, sk, bias=bias, out_dtype=out_dtype)
    qk = torch.nn.functional.pad(qk, (0, pad))
    sk = torch.nn.functional.pad(sk, (0, pad), value=1.0)
    bias = None if bias is None else torch.nn.functional.pad(bias, (0, pad))
    return int8_matmul(qx, qk, sx, sk, bias=bias, out_dtype=out_dtype)[:, :n]


def int8_dense(x: torch.Tensor, kernel: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *, out_dtype=None,
               impl: str = "xla") -> torch.Tensor:
    """``x @ kernel + bias`` with both operands dynamically quantized to int8.

    x ``[..., K]`` (any float dtype), kernel ``[K, N]`` (quantized per output
    channel), bias ``[N]`` added in f32 after dequantization; the result is
    ``out_dtype`` (default ``x.dtype``)."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown int8_dense impl {impl!r}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    qx, sx = quantize_rows_int8(x)
    qk, sk = quantize_cols_int8(kernel)
    lead = qx.shape[:-1]
    k, n = qx.shape[-1], kernel.shape[-1]
    qx, sx = qx.reshape(-1, k), sx.reshape(-1, 1)
    bias32 = None if bias is None else bias.float()
    if impl == "pallas":
        return int8_matmul_padded(qx, qk, sx, sk, bias32, out_dtype).reshape(*lead, n)
    out = dequantize(_int_product(qx, qk), sx, sk, bias32, fused=False)
    return out.reshape(*lead, n).to(out_dtype)


class Int8Dense(nn.Linear):
    """Drop-in for the ``nn.Linear`` it replaces on the W8A8 path: the same
    parameters (``weight [out, in]``, ``bias [out]``), so converted
    checkpoints load unchanged and a quantized model's state dict is the
    unquantized model's.  ``out_dtype`` is the activation dtype the result
    is cast to; ``impl`` is ``"xla"`` or ``"pallas"`` (kernel 7)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, out_dtype=torch.float32, impl: str = "xla"):
        super().__init__(in_features, out_features, bias=bias)
        if impl not in ("xla", "pallas"):
            raise ValueError(f"unknown int8_dense impl {impl!r}")
        self.out_dtype = out_dtype
        self.impl = impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_dense(x, self.weight.t(), self.bias,
                          out_dtype=self.out_dtype, impl=self.impl)
