"""Fused stride-1 folded-BatchNorm bottleneck block, implicit GEMM: the port
of ``debiasing_multi_modal_tpu/ops/conv_gemm.py`` (kernel 8, ``_body``).

:func:`fused_bottleneck_gemm` computes one RN50 bottleneck block whose
BatchNorms are folded into its convolutions (``weights/fold.py``): conv1 1x1
+ bias + ReLU, conv2 3x3 + bias + ReLU, conv3 1x1 + bias, an optional 1x1
downsample, the residual add and the final ReLU, on NHWC activations
``[B, H, W, Cin]``, with the weights in the JAX layouts (``w1 [Cin, M]``,
``w2 [3, 3, M, M]``, ``w3 [M, Cout]``, ``wd [Cin, Cout]``).  On a CUDA tensor
it launches the hand-written kernel in ``csrc/bottleneck.cu`` (one block per
image group and row strip; y1 and y2 stay in shared memory; every product
on the tensor cores with ``mma.sync``, bf16 as such and f32 as split-TF32,
three TF32 products per product) or raises; on a CPU
tensor it runs :func:`xla_bottleneck`, the plain PyTorch version with the
JAX kernel's roundings.  There is no fall back from one to the other;
``fused_bottleneck_gemm.launches`` counts the kernel's launches.

As in the JAX package, the model never calls the kernel (``models/resnet.py``
keeps ``F.conv2d``): it is driven at the folded RN50's stride-1 blocks by
``chip_smoke.py`` and ``utils/profiling.py --bottleneck``, with
:func:`block_weights` pulling a folded block's weights into these layouts.

The H100 gate is shared memory: the kernel keeps a zero-bordered
``[G, S+2, W+2, M]`` y1 tile and a ``[G, S, W, M]`` y2 tile of the
activation dtype per block, and a ring of four stage buffers of weight (and
x) tiles (:func:`smem_bytes`), against the 232,448 bytes a block may use;
:func:`pick_strip_rows` gives the largest strip that fits.  A block holds an
SM, so where a small batch gives fewer blocks than SMs a smaller strip may
be faster: the caller picks it (``strip_rows``).  bf16 takes channel counts
that are multiples of 16 (the ``k16`` step of ``mma.sync``), f32 multiples of
8 (the ``k8`` step of its TF32 form).  The TPU's VMEM sizing does not carry
over.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from debiasing_multi_modal_tpu_torch.ops import cuda_build
from debiasing_multi_modal_tpu_torch.utils.platform import full_f32

# A Hopper block may use 232,448 bytes of shared memory (227 KB).
SMEM_LIMIT_BYTES = 232448
# channel multiple per dtype: the k step of one mma.sync, k8 for the TF32
# products of f32, k16 for bf16
_CHANNEL_VECTOR = {torch.float32: 8, torch.bfloat16: 16}
# the ring of stage buffers, in either dtype (csrc/bottleneck.cu kStages *
# kStageBytes)
_STAGE_BYTES = 4 * 20480
_MAX_GRID_Y = 65535  # image groups ride the grid's y dimension
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(w: int, m: int, strip_rows: int, images_per_cell: int,
               itemsize: int) -> int:
    """Dynamic shared memory of one kernel-8 (or kernel-9) block (mirrors
    ``smem_bytes`` in the CUDA source): the zero-bordered y1 tile of the
    strip and its halo rows, and the strip's y2 tile, of the activation
    dtype, and the ring of stage buffers."""
    g, s = images_per_cell, strip_rows
    tiles = (g * (s + 2) * (w + 2) * m + g * s * w * m) * itemsize
    return tiles + _STAGE_BYTES


def pick_strip_rows(h: int, w: int, m: int, itemsize: int,
                    images_per_cell: int = 1) -> Optional[int]:
    """The largest strip (a divisor of ``h``) whose tiles fit a block, or
    None."""
    fits = [s for s in range(1, h + 1) if h % s == 0
            and smem_bytes(w, m, s, images_per_cell, itemsize) <= SMEM_LIMIT_BYTES]
    return max(fits) if fits else None


def supported(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, *, strip_rows: int,
              images_per_cell: int = 1) -> bool:
    """Whether kernel 8 takes this call on the card: f32 or bf16, channel
    counts that are multiples of 8 (f32) or 16 (bf16), and the strip's
    tiles in shared memory."""
    if x.ndim != 4 or x.dtype not in _DTYPE_CODES or w1.ndim != 2 or w3.ndim != 2:
        return False
    b, h, w, cin = x.shape
    m, cout = w1.shape[1], w3.shape[1]
    if h % strip_rows or b % images_per_cell or b // images_per_cell > _MAX_GRID_Y:
        return False
    vec = _CHANNEL_VECTOR[x.dtype]
    if cin % vec or m % vec or cout % vec:
        return False
    return smem_bytes(w, m, strip_rows, images_per_cell, x.element_size()) <= SMEM_LIMIT_BYTES


def _check(x, w1, w3, wd, bd, strip_rows, images_per_cell):
    """The JAX wrapper's asserts (conv_gemm.py:182-184, 171, 175), as errors."""
    if x.ndim != 4 or w1.ndim != 2 or w3.ndim != 2 or x.shape[3] != w1.shape[0]:
        raise ValueError(f"shapes do not chain: x {tuple(x.shape)}, w1 {tuple(w1.shape)}")
    b, h, _, cin = x.shape
    if h % strip_rows:
        raise ValueError(f"H ({h}) must be a multiple of strip_rows ({strip_rows})")
    if b % images_per_cell:
        raise ValueError(f"B ({b}) must be a multiple of images_per_cell ({images_per_cell})")
    if (wd is None) != (bd is None):
        raise ValueError("the downsample weight wd and its bias bd come together")
    if wd is None and cin != w3.shape[1]:
        raise ValueError(f"without a downsample Cin ({cin}) must equal Cout ({w3.shape[1]})")


def xla_bottleneck(x: torch.Tensor, w1, b1, w2, b2, w3, b3, wd=None, bd=None) -> torch.Tensor:
    """Plain PyTorch version of the block (the counterpart of the JAX
    package's ``xla_bottleneck``, conv_gemm.py:193-217): every convolution
    of ``x.dtype`` operands accumulates in f32 (``F.conv2d`` on the values
    widened to f32, which are exact), and y1, y2, y3 and the downsample
    output are each cast to ``x.dtype`` after their bias; the residual add
    and the final ReLU run in ``x.dtype``.  The f32 convolutions run in full
    f32, never as TF32, whatever cuDNN's process-wide switch says.  NHWC in,
    NHWC out."""
    dt = x.dtype

    def conv(h, kernel_oihw, padding):
        return F.conv2d(h.float(), kernel_oihw.to(dt).float(), padding=padding)

    def bias(b):
        return b.float()[:, None, None]

    def one_by_one(wt):  # [I, O] -> OIHW
        return wt.t()[:, :, None, None]

    h = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC activations
    with full_f32():
        y = torch.relu(conv(h, one_by_one(w1), 0) + bias(b1)).to(dt)
        y = torch.relu(conv(y, w2.permute(3, 2, 0, 1), 1) + bias(b2)).to(dt)
        y = (conv(y, one_by_one(w3), 0) + bias(b3)).to(dt)
        r = h if wd is None else (conv(h, one_by_one(wd), 0) + bias(bd)).to(dt)
    return torch.relu(y + r).permute(0, 2, 3, 1).contiguous()


def block_weights(block) -> Tuple[torch.Tensor, ...]:
    """``(w1, b1, w2, b2, w3, b3, wd, bd)`` of a folded stride-1
    :class:`~debiasing_multi_modal_tpu_torch.models.resnet.Bottleneck`, in
    the JAX layouts (OIHW conv weights turned into ``[I, O]`` and
    ``[3, 3, I, O]``); ``wd`` and ``bd`` are None without a downsample."""
    if block.stride != 1 or block.conv1.bias is None:
        raise ValueError("block_weights takes a folded (fuse_bn) stride-1 Bottleneck")

    def one_by_one(conv):
        return conv.weight[:, :, 0, 0].t()

    wd = bd = None
    if block.downsample is not None:
        wd, bd = one_by_one(block.downsample[0]), block.downsample[0].bias
    return (one_by_one(block.conv1), block.conv1.bias,
            block.conv2.weight.permute(2, 3, 1, 0), block.conv2.bias,
            one_by_one(block.conv3), block.conv3.bias, wd, bd)


def _need(cond, msg):
    if not cond:
        raise ValueError(msg)


def _card_operands(x, weights, biases, smem, who):
    """The kernel's operands on the card: contiguous weights of x's dtype,
    contiguous f32 biases; raises on what the kernel does not take."""
    _need(x.device.type == "cuda", f"{who} runs on cuda or cpu, not {x.device}")
    _need(x.dtype in _DTYPE_CODES, f"the CUDA {who} takes f32 or bf16, not {x.dtype}")
    _need(smem <= SMEM_LIMIT_BYTES,
          f"{who}: the strip's tiles need {smem} bytes of shared memory, more than "
          f"{SMEM_LIMIT_BYTES}")
    x = x.contiguous()
    ws = [None if t is None else t.to(x.dtype).contiguous() for t in weights]
    bs = [None if t is None else t.float().contiguous() for t in biases]
    for t in [x, *ws, *bs]:
        if t is None:
            continue
        _need(t.device == x.device, f"{who} operands must lie on one device")
        _need(t.data_ptr() % 16 == 0, f"{who} needs 16-byte aligned operands")
    vec = _CHANNEL_VECTOR[x.dtype]
    _need(all(d % vec == 0 for d in (ws[0].shape[0], ws[0].shape[1], ws[2].shape[1])),
          f"{who} in {x.dtype} needs channel counts that are multiples of {vec}")
    return x, ws, bs


def fused_bottleneck_gemm(x: torch.Tensor, w1, b1, w2, b2, w3, b3, wd=None, bd=None,
                          *, strip_rows: int = 8, images_per_cell: int = 1) -> torch.Tensor:
    """x ``[B, H, W, Cin]`` (f32 or bf16) -> ``[B, H, W, Cout]`` of x's
    dtype: kernel 8 on a CUDA tensor (one block per ``images_per_cell``
    images and ``strip_rows`` rows), :func:`xla_bottleneck` on a CPU one."""
    _check(x, w1, w3, wd, bd, strip_rows, images_per_cell)
    if x.device.type == "cpu":
        return xla_bottleneck(x, w1, b1, w2, b2, w3, b3, wd, bd)
    b, h, w, cin = x.shape
    m, cout = w1.shape[1], w3.shape[1]
    _need(b // images_per_cell <= _MAX_GRID_Y, f"B={b} exceeds the kernel's grid")
    smem = smem_bytes(w, m, strip_rows, images_per_cell, x.element_size())
    x, (w1, w2, w3, wd), (b1, b2, b3, bd) = _card_operands(
        x, (w1, w2.reshape(9 * m, m), w3, wd), (b1, b2, b3, bd), smem,
        "fused_bottleneck_gemm")
    out = torch.empty(b, h, w, cout, device=x.device, dtype=x.dtype)
    cuda_build.launch("bottleneck", "bottleneck_gemm_forward",
                      (x, w1, b1, w2, b2, w3, b3, wd, bd, out),
                      (b, h, w, cin, m, cout, strip_rows, images_per_cell,
                       _DTYPE_CODES[x.dtype]), x.device)
    fused_bottleneck_gemm.launches += 1
    return out


fused_bottleneck_gemm.launches = 0
