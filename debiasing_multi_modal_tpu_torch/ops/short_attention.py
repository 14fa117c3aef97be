"""Whole-row merged-head self-attention: the port of
``debiasing_multi_modal_tpu/ops/short_attention.py::_short_attn_kernel``.

q, k, v are ``[B, S, D]`` in merged-head layout (head h is the column slice
``[h*hd, (h+1)*hd)``) and so is the output, exactly the layout the
surrounding projection GEMMs produce and consume — no transposes on either
side.  Scores are f32 and exact over the whole row; probabilities are cast
to the input dtype before P.V, which accumulates in f32.

On a CUDA tensor :func:`short_attention` launches the hand-written kernel in
``csrc/short_attention.cu`` or raises; on a CPU tensor it runs
:func:`short_attention_reference`, the plain PyTorch version (the counterpart
of the JAX package's ``_xla_merged``).  There is no fall back from one to the
other.

The H100 gate :func:`supported` is derived from shared memory: one block
stages one head's K_h and V_h (``[S, hd]`` each, rows padded by one 32-bit
word) plus eight warps' score rows and query rows, and that must fit the
227 KB a block may use.  The TPU's VMEM byte models, batch-block pickers and
image merging do not carry over.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_NEG_INF = -1e30
# A Hopper block may use 232,448 bytes of shared memory (227 KB).
SMEM_LIMIT_BYTES = 232448
_WARPS = 8  # warps per block, csrc/short_attention.cu kWarps
HEAD_DIMS = (32, 64, 128)  # the head widths the kernel is instantiated for
_MAX_GRID_Z = 65535  # images ride the grid's z dimension
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(s: int, hd: int, itemsize: int) -> int:
    """Dynamic shared memory of one block (mirrors ``smem_bytes`` in the
    CUDA source): padded K_h and V_h, plus each warp's f32 scores and
    query row."""
    ld = hd + (2 if itemsize == 2 else 1)
    return 2 * s * ld * itemsize + _WARPS * (s + hd) * 4


def supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int, *, mask: Optional[torch.Tensor] = None) -> bool:
    """Whether the CUDA kernel takes this call."""
    if mask is not None:
        return False
    if q.ndim != 3 or q.shape != k.shape or k.shape != v.shape:
        return False
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        return False
    b, s, d = q.shape
    if s < 1 or not (1 <= b <= _MAX_GRID_Z) or d % num_heads:
        return False
    hd = d // num_heads
    if hd not in HEAD_DIMS:
        return False
    return smem_bytes(s, hd, q.element_size()) <= SMEM_LIMIT_BYTES


def short_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, num_heads: int,
                              causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version: f32 logits, whole-row softmax, probabilities
    rounded to the input dtype, f32 P.V accumulation."""
    b, s, d = q.shape
    hd = d // num_heads
    qh = q.reshape(b, s, num_heads, hd).float()
    kh = k.reshape(b, s, num_heads, hd).float()
    vh = v.reshape(b, s, num_heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (hd ** -0.5)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, _NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype).float(), vh.float())
    return out.to(q.dtype).reshape(b, s, d)


def _check(q, k, v, num_heads):
    if q.ndim != 3 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(
            f"short_attention takes equal [B, S, D] q/k/v, got "
            f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}"
        )
    if q.shape[2] % num_heads:
        raise ValueError(f"D={q.shape[2]} is not divisible by {num_heads} heads")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


_forward = None  # the C entry, typed once when its library loads


def _load_forward():
    global _forward
    from debiasing_multi_modal_tpu_torch.ops import cuda_build

    fn = cuda_build.library("short_attention").short_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _forward = fn
    return fn


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, *, causal: bool = False) -> torch.Tensor:
    """q/k/v ``[B, S, D]`` merged-head -> ``[B, S, D]``.

    CPU tensors take :func:`short_attention_reference`; CUDA tensors launch
    the kernel (``short_attention.launches`` counts those launches) or raise
    on anything it does not take."""
    _check(q, k, v, num_heads)
    if q.device.type == "cpu":
        return short_attention_reference(q, k, v, num_heads, causal)
    if q.device.type != "cuda":
        raise ValueError(f"short_attention runs on cuda or cpu, not {q.device}")
    if not supported(q, k, v, num_heads):
        raise ValueError(
            f"the CUDA short_attention kernel does not take q{tuple(q.shape)} "
            f"{q.dtype} heads={num_heads} (see supported())"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("short_attention needs contiguous q, k and v")
    fn = _forward or _load_forward()
    b, s, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, d, num_heads, int(causal), _DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(f"short_attention kernel launch failed: CUDA error {err}")
    short_attention.launches += 1
    return out


short_attention.launches = 0
