"""Fused stride-1 folded-BatchNorm bottleneck block as nine shifted products:
the port of ``debiasing_multi_modal_tpu/ops/fused_bottleneck.py`` (kernel 9,
``_kernel``).

:func:`fused_bottleneck` computes the identity-residual block (``Cin ==
Cout``, no downsample) that kernel 8 also computes, with conv2 summed the
way the JAX kernel sums it: each of the nine (dy, dx) shifts of the
zero-padded y1 tile as its own f32 product, added to the accumulator.  On a
CUDA tensor it launches ``bottleneck_shifted_forward`` in
``csrc/bottleneck.cu`` (kernel 8's device code, one image per block) or
raises; on a CPU tensor it runs the plain version,
:func:`~debiasing_multi_modal_tpu_torch.ops.conv_gemm.xla_bottleneck`
without the downsample.  ``fused_bottleneck.launches`` counts the kernel's
launches.

Of RN50's 16 blocks, the 12 stride-1 blocks without a downsample qualify
(the JAX docstring's "13" counts layer1 block 0, whose downsample only
kernel 8 takes).  The JAX VMEM picker ``_images_per_cell`` does not carry
over: the kernel takes one image per block and the largest row strip whose
tiles and ring of stage buffers fit shared memory (:func:`strip_rows`,
:func:`smem_bytes`).
"""

from __future__ import annotations

from typing import Optional

import torch

from debiasing_multi_modal_tpu_torch.ops import conv_gemm, cuda_build


def strip_rows(h: int, w: int, m: int, itemsize: int) -> Optional[int]:
    """Kernel 9's row strip: the largest divisor of ``h`` whose tiles fit a
    block, or None."""
    return conv_gemm.pick_strip_rows(h, w, m, itemsize)


def smem_bytes(h: int, w: int, m: int, itemsize: int) -> Optional[int]:
    """Dynamic shared memory of one kernel-9 block at its strip, or None if
    no strip fits."""
    s = strip_rows(h, w, m, itemsize)
    return None if s is None else conv_gemm.smem_bytes(w, m, s, 1, itemsize)


def supported(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor) -> bool:
    """Whether kernel 9 takes this call on the card: ``Cin == Cout`` and
    kernel 8's conditions at its own strip."""
    if x.ndim != 4 or w1.ndim != 2 or tuple(w3.shape) != (w1.shape[1], x.shape[3]):
        return False
    s = strip_rows(x.shape[1], x.shape[2], w1.shape[1], x.element_size())
    return s is not None and conv_gemm.supported(x, w1, w3, strip_rows=s)


def fused_bottleneck(x: torch.Tensor, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """x ``[B, H, W, C]`` (f32 or bf16), ``w1 [C, M]``, ``w2 [3, 3, M, M]``,
    ``w3 [M, C]``, f32 biases -> ``[B, H, W, C]`` of x's dtype."""
    c, m = x.shape[-1], w1.shape[1]
    if tuple(w3.shape) != (m, c):
        raise ValueError(f"w3 must be [{m}, {c}] (Cin == Cout), got {tuple(w3.shape)}")
    conv_gemm._check(x, w1, w3, None, None, 1, 1)
    if x.device.type == "cpu":
        return conv_gemm.xla_bottleneck(x, w1, b1, w2, b2, w3, b3)
    b, h, w, _ = x.shape
    s = strip_rows(h, w, m, x.element_size())
    if s is None or b > conv_gemm._MAX_GRID_Y:
        raise ValueError(f"fused_bottleneck takes no strip of H={h}, W={w}, M={m}, B={b}")
    x, (w1, w2, w3), (b1, b2, b3) = conv_gemm._card_operands(
        x, (w1, w2.reshape(9 * m, m), w3), (b1, b2, b3),
        conv_gemm.smem_bytes(w, m, s, 1, x.element_size()), "fused_bottleneck")
    out = torch.empty_like(x)
    cuda_build.launch("bottleneck", "bottleneck_shifted_forward",
                      (x, w1, b1, w2, b2, w3, b3, out),
                      (b, h, w, c, m, s, conv_gemm._DTYPE_CODES[x.dtype]), x.device)
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0
