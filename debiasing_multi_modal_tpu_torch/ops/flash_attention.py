"""Blockwise (flash) attention, forward and backward: the port of
``debiasing_multi_modal_tpu/ops/flash_attention.py``.

Three kernels in ``csrc/flash_attention.cu``:

- kernel 4 (``_attn_fwd_kernel``): online-softmax attention that also emits
  the row logsumexp, the training residual;
- kernel 5 (``_bwd_dq_kernel``): dQ over the saved logsumexp;
- kernel 6 (``_bwd_dkv_kernel``): dK and dV.

All three run on the tensor cores in bf16 (``mma.sync``, ``ldmatrix``,
double-buffered ``cp.async``; kernel 4 runs its online softmax in
registers), and in f32 as split-TF32 (``csrc/flash_f32_tc.cuh``: each
operand split into TF32 hi and lo parts, three TF32 products per product,
f32 accumulators).

:func:`flash_attention` takes q ``[B, Sq, H, hd]`` and k, v
``[B, Skv, H, hd]`` (the layout of ``dot_product_attention``: the ``[B, S, D]``
projection outputs viewed head-split) and returns ``[B, Sq, H, hd]``.  It is
differentiable through :class:`_Flash`, a ``torch.autograd.Function`` whose
forward returns ``(out, lse)`` and whose backward runs kernels 5 and 6 over
``delta = sum_d dO * O`` (one plain reduction, as XLA computes it outside
the TPU kernels).  On a CPU tensor the same Function runs the plain versions
(:func:`flash_attention_reference`, :func:`flash_attention_backward_reference`);
on a CUDA tensor it launches the kernels or raises, and never falls back.
Each kernel counts its launches: ``flash_attention.launches`` (kernel 4),
``flash_attention_dq.launches`` (5) and ``flash_attention_dkv.launches`` (6).

``causal`` masks key j from query i when j > i (top-left aligned, so Sq may
differ from Skv); a ragged S edge is masked inside the kernels, never padded.
The H100 gate (:func:`supported`) is derived from the kernels' shared memory
(64-row q and kv tiles, staged in their own dtype: it depends on hd and the
dtype only).
The TPU knobs do not carry over: ``_pick_blocks``, ``_heads_per_cell``,
``_BWD_VMEM_BUDGET``, ``block_q``/``block_kv``/``heads_per_cell``,
``interpret``, and the auto-dispatch thresholds ``MIN_AUTO_SEQ_LEN`` and
``SCORE_BYTES_THRESHOLD`` (see ``ops/attention.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from debiasing_multi_modal_tpu_torch.ops import cuda_build
from debiasing_multi_modal_tpu_torch.ops.short_attention import (
    HEAD_DIMS,
    SMEM_LIMIT_BYTES,
    _need_aligned,
)

_NEG_INF = -1e30
TILE = 64  # q rows per q tile and keys per kv tile, csrc/flash_attention.cu kTile
_MAX_GRID_YZ = 65535  # heads ride the grid's y dimension, images its z
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_F32 = 4


def _f32tc_tile_bytes(hd: int) -> int:
    return TILE * hd * _F32  # a staged [64, hd] f32 tile, swizzled, unpadded


def _tc_tile_bytes(hd: int) -> int:
    return TILE * hd * 2  # a staged [64, hd] bf16 tile, swizzled, unpadded


def fwd_smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Kernel 4's shared memory (mirrors ``fwd_tc_smem_bytes`` and
    ``f32tc::fwd_smem_bytes`` in the CUDA source): bf16 the q tile and two
    K/V buffers; f32 the q tile and one K/V buffer (more blocks per SM)."""
    if dtype == torch.bfloat16:
        return 5 * _tc_tile_bytes(hd)
    return 3 * _f32tc_tile_bytes(hd)


def dq_smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Kernel 5's (``dq_tc_smem_bytes`` and ``f32tc::dq_smem_bytes`` in the
    CUDA source): q and dO tiles and two K/V buffers, in either dtype."""
    if dtype == torch.bfloat16:
        return 6 * _tc_tile_bytes(hd)
    return 6 * _f32tc_tile_bytes(hd)


def dkv_smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Kernel 6's (``dkv_tc_smem_bytes``, ``f32tc::dkv_smem_bytes``): k and
    v tiles and two q/dO buffers, each with its q tile's logsumexp and
    delta, in either dtype."""
    tile = _tc_tile_bytes(hd) if dtype == torch.bfloat16 else _f32tc_tile_bytes(hd)
    return 6 * tile + 2 * 2 * TILE * _F32


def supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              mask: Optional[torch.Tensor] = None) -> bool:
    """Whether the kernels take this call on the card: no mask, q
    ``[B, Sq, H, hd]`` and k, v ``[B, Skv, H, hd]`` of one dtype (f32 or
    bf16), hd with an instantiation whose three kernels fit a block's shared
    memory, any Sq and Skv of at least 1."""
    if mask is not None or q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        return False
    b, sq, h, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, hd):
        return False
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        return False
    if sq < 1 or k.shape[1] < 1 or not (1 <= b <= _MAX_GRID_YZ and 1 <= h <= _MAX_GRID_YZ):
        return False
    smem = max(fwd_smem_bytes(hd, q.dtype), dq_smem_bytes(hd, q.dtype),
               dkv_smem_bytes(hd, q.dtype))
    return hd in HEAD_DIMS and smem <= SMEM_LIMIT_BYTES


def _keep(sq: int, skv: int, device) -> torch.Tensor:
    """[Sq, Skv] causal mask, top-left aligned: key j is seen by query i >= j."""
    return torch.ones(sq, skv, dtype=torch.bool, device=device).tril()


def _scores(q, k, causal):
    """f32 logits ``[B, H, Sq, Skv]``, scaled after the dot as the kernels do,
    masked keys at -1e30."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if causal:
        s = s.masked_fill(~_keep(q.shape[1], k.shape[1], q.device), _NEG_INF)
    return s


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel 4, whole-row: f32 logits, the row max,
    ``exp(s - m)`` rounded to v's dtype before an f32 P.V, divided by the
    row sum of the unrounded exponentials.  Returns ``(out, lse)``: out in
    q's dtype, lse ``[B, H, Sq]`` f32."""
    s = _scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)  # masked keys underflow to exactly 0
    l = e.sum(-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), v.float())
    out = (pv / l.permute(0, 2, 1, 3)).to(q.dtype)
    return out, (m + torch.log(l)).squeeze(-1)


def flash_attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = sum_d dO * O`` in f32, ``[B, H, Sq]`` (the backward's
    row term, outside the kernels as in the JAX package)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_backward_reference(q, k, v, out, lse, dout, causal=False):
    """Plain version of kernels 5 and 6: ``p = exp(s - lse)`` (masked keys 0),
    ``dp = dO.v^T`` and ``ds = p * (dp - delta) * scale`` in f32; dq sums
    ds rounded to k's dtype against k, dk sums ds rounded to q's dtype
    against q, dv sums p rounded to dO's dtype against dO, each in f32 and
    returned in its input's dtype.  Returns ``(dq, dk, dv)``."""
    scale = q.shape[-1] ** -0.5
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    if causal:
        p = p.masked_fill(~_keep(q.shape[1], k.shape[1], q.device), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - flash_attention_delta(out, dout)[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dout.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------- the kernels --


def _dims(q, k):
    b, sq, h, hd = q.shape
    return b, sq, k.shape[1], h, hd


def flash_attention_forward(q, k, v, causal: bool = False):
    """Kernel 4 on CUDA tensors that :func:`supported` takes and that are
    contiguous: ``(out, lse)``, counted in ``flash_attention.launches``.  The
    kernel stages tiles by 16-byte ``cp.async`` in both dtypes: q, k and v
    must be 16-byte aligned."""
    _need_aligned("flash_attention", q, k, v, dtypes=(torch.bfloat16, torch.float32))
    out = torch.empty_like(q)
    b, sq, skv, h, hd = _dims(q, k)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    cuda_build.launch("flash_attention", "flash_attention_forward", (q, k, v, out, lse),
                      (b, sq, skv, h, hd, int(causal), _DTYPE_CODES[q.dtype]), q.device)
    flash_attention.launches += 1
    return out, lse


def flash_attention_dq(q, k, v, dout, lse, delta, causal: bool = False):
    """Kernel 5: dq, counted in ``flash_attention_dq.launches``.  The kernel
    stages tiles by 16-byte ``cp.async`` in both dtypes: q, k, v and dout
    must be 16-byte aligned."""
    _need_aligned("flash_attention_dq", q, k, v, dout,
                  dtypes=(torch.bfloat16, torch.float32))
    dq = torch.empty_like(q)
    b, sq, skv, h, hd = _dims(q, k)
    cuda_build.launch("flash_attention", "flash_attention_dq",
                      (q, k, v, dout, lse, delta, dq),
                      (b, sq, skv, h, hd, int(causal), _DTYPE_CODES[q.dtype]), q.device)
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, dout, lse, delta, causal: bool = False):
    """Kernel 6: ``(dk, dv)``, counted in ``flash_attention_dkv.launches``;
    aligned as kernel 5."""
    _need_aligned("flash_attention_dkv", q, k, v, dout,
                  dtypes=(torch.bfloat16, torch.float32))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    b, sq, skv, h, hd = _dims(q, k)
    cuda_build.launch("flash_attention", "flash_attention_dkv",
                      (q, k, v, dout, lse, delta, dk, dv),
                      (b, sq, skv, h, hd, int(causal), _DTYPE_CODES[q.dtype]), q.device)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


class _Flash(torch.autograd.Function):
    """``(out, lse)`` of q, k, v; the backward is kernels 5 and 6 on the card
    and their plain version on the CPU (the counterpart of the JAX
    package's ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            out, lse = flash_attention_reference(q, k, v, causal)
        else:
            out, lse = flash_attention_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            return (*flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                        ctx.causal), None)
        dout = dout.contiguous()
        delta = flash_attention_delta(out, dout)
        dq = flash_attention_dq(q, k, v, dout, lse, delta, ctx.causal)
        dk, dv = flash_attention_dkv(q, k, v, dout, lse, delta, ctx.causal)
        return dq, dk, dv, None


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or (
            (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3])):
        raise ValueError(
            f"flash_attention takes q [B, Sq, H, hd] and k, v [B, Skv, H, hd], got "
            f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` that also returns the row logsumexp
    ``[B, H, Sq]`` f32 (not differentiable)."""
    _check(q, k, v)
    if q.device.type == "cuda":
        if not supported(q, k, v):
            raise ValueError(
                f"flash_attention on the card does not take q{tuple(q.shape)} "
                f"k{tuple(k.shape)} {q.dtype} (see supported())")
        if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
            raise ValueError("flash_attention needs contiguous inputs")
    return _Flash.apply(q, k, v, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Fused attention: q ``[B, Sq, H, hd]``, k/v ``[B, Skv, H, hd]`` ->
    ``[B, Sq, H, hd]``, differentiable.  CPU tensors take the plain
    versions; CUDA tensors launch kernels 4 (forward), 5 and 6 (backward)
    where :func:`supported` holds, and raise otherwise.  A mask raises:
    additive masks use the plain formulation, as in the JAX package."""
    if mask is not None:
        raise ValueError("additive masks use the xla path")
    return flash_attention_with_lse(q, k, v, causal=causal)[0]


flash_attention.launches = 0
