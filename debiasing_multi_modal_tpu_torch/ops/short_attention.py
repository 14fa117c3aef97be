"""Merged-head self-attention kernels: the port of
``debiasing_multi_modal_tpu/ops/short_attention.py``.

Three kernels share one function (f32 logits, an exact whole-row softmax,
probabilities cast to the input dtype before P.V, which accumulates in f32):

- kernel 1, whole-row (``_short_attn_kernel``), ``csrc/short_attention.cu``;
- kernel 2, q-tiled (``_qtiled_kernel``), ``csrc/short_attention_qtiled.cu``,
  for sequences whose whole-row block does not fit shared memory;
- kernel 3, packed (``_packed_attn_kernel``), ``csrc/short_attention.cu``,
  which reads q, k and v from one ``[B, S, 3D]`` slab, the fused
  in-projection GEMM's output.

q, k, v are ``[B, S, D]`` in merged-head layout (head h is the column slice
``[h*hd, (h+1)*hd)``) and so is the output, exactly the layout the
surrounding projection GEMMs produce and consume — no transposes on either
side.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs the plain PyTorch version (:func:`short_attention_reference`, the
counterpart of the JAX package's ``_xla_merged``; kernel 2 has the same math
and so the same plain version; kernel 3's splits the slab and calls it).
There is no fall back from one to the other.

Each kernel is differentiable: where grad is on and an input requires it,
the launch runs inside :class:`_PlainVJP`, whose backward is the VJP of the
plain merged-head formulation recomputed from the saved inputs — the JAX
package's ``_short_bwd`` and ``_short_packed_bwd``, which also compute the
backward outside any kernel.  The packed kernel's gradient is one
``[B, S, 3D]`` tensor (dq | dk | dv).  Under ``torch.inference_mode()``, or
with no input requiring grad, the wrappers launch exactly as before and save
nothing.  :func:`short_attention` picks
kernel 1 when its block fits and kernel 2 otherwise, as the JAX package's
``_pallas_forward`` picks whole-row before q-tiled.  Each wrapper counts its
own launches (``short_attention.launches``, ``short_attention_qtiled.launches``,
``short_attention_packed.launches``).

The H100 gates are derived from shared memory, against the 227 KB a block
may use (:func:`smem_bytes`, :func:`qtiled_smem_bytes`).  In bf16 kernels 1
and 3 run on the tensor cores (``mma.sync``, ``ldmatrix``, 16-byte
``cp.async``) and stage one head's K_h and V_h, rows rounded up to 16 and
swizzled, plus one 16-row Q tile per warp; bf16 kernel 2 stages 32 query
rows' f32 score and query rows plus one padded 64-key tile.  In f32 all
three run one device code on the CUDA cores (``csrc/attention_f32.cuh``),
with register tiles of logits and outputs, for a tile of 32 or 64 query
rows: kernels 1 and 3 keep K_h and V_h resident beside the tile's f32 score
rows (:func:`f32_resident_rows`), kernel 2 streams them through 128- or
64-key tiles (:func:`f32_streamed_tile`), and all three sum in one order, so their f32
outputs are bit-equal.  Every copy by 16-byte ``cp.async`` needs 16-byte
aligned base pointers; the wrappers raise on a misaligned view.  The TPU's VMEM
constants (``MAX_SEQ_LEN``, ``CELL_VMEM_LIMIT``, ``TILED_CELL_LIMIT``,
``pick_block_q``), batch-block pickers and image merging do not carry over.
"""

from __future__ import annotations

from typing import Optional

import torch

from debiasing_multi_modal_tpu_torch.ops import cuda_build

_NEG_INF = -1e30
# A Hopper block may use 232,448 bytes of shared memory (227 KB).
SMEM_LIMIT_BYTES = 232448
_Q_TILE = 32  # query rows per bf16 kernel-2 block, csrc/short_attention_qtiled.cu kQTile
_K_TILE = 64  # keys per bf16 kernel-2 K/V tile, kKTile
HEAD_DIMS = (32, 64, 128)  # the head widths the kernels are instantiated for
_MAX_GRID_Z = 65535  # images ride the grid's z dimension
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CP_ASYNC_DTYPES = (torch.float32, torch.bfloat16)  # kernels 1 and 3 copy both by cp.async


def _padded_ld(hd: int, itemsize: int) -> int:
    return hd + (2 if itemsize == 2 else 1)


def _tc_warps(s: int, hd: int) -> int:
    """Warps of one bf16 kernel-1 block: one per 16 query rows, at most 8
    (4 at hd 128), ``tc_warps`` in the CUDA source."""
    return min(4 if hd == 128 else 8, -(-s // 16))


def _round4(s: int) -> int:
    return -(-s // 4) * 4


def _score_ld(s: int) -> int:
    """``f32attn::score_ld``: the f32 score rows' stride, S rounded up to 4,
    plus 4 where that is a multiple of 32 (bank groups)."""
    return _round4(s) + (4 if _round4(s) % 32 == 0 else 0)


def _f32_resident_bytes(s: int, hd: int, rows: int) -> int:
    """``f32attn::resident_smem_bytes``: the q rows, the f32 score rows
    (:func:`_score_ld` apart) and K_h, V_h (``round4(S)`` rows each, at least
    64, ``resident_kv_rows``)."""
    return 4 * (rows * hd + rows * _score_ld(s) + 2 * max(_round4(s), 64) * hd)


def _f32_streamed_bytes(s: int, hd: int, rows: int, bufs: int, keys: int) -> int:
    """``f32attn::streamed_smem_bytes``: the q rows, the f32 score rows and
    ``bufs`` K/V tiles of ``keys`` keys."""
    return 4 * (rows * hd + rows * _score_ld(s) + bufs * keys * hd)


def f32_resident_rows(s: int, hd: int) -> int:
    """Query rows per f32 kernel-1 block (``f32attn::resident_rows``): 32 up
    to S = 128, then 64 where they fit."""
    return 64 if s > 128 and _f32_resident_bytes(s, hd, 64) <= SMEM_LIMIT_BYTES else 32


def f32_streamed_tile(s: int, hd: int) -> tuple:
    """(query rows, K/V buffers, keys per buffer) of an f32 kernel-2 block
    (``f32attn::streamed_tile``): 64 rows and two 128-key buffers where they
    fit, else 32 rows and two 64-key buffers, else 32 rows and one."""
    if _f32_streamed_bytes(s, hd, 64, 2, 128) <= SMEM_LIMIT_BYTES:
        return 64, 2, 128
    if _f32_streamed_bytes(s, hd, 32, 2, 64) <= SMEM_LIMIT_BYTES:
        return 32, 2, 64
    return 32, 1, 64


def smem_bytes(s: int, hd: int, itemsize: int) -> int:
    """Dynamic shared memory of one kernel-1 (or kernel-3) block (mirrors
    ``smem_bytes_bf16`` in the CUDA source and ``f32attn::resident_smem_bytes``
    in ``csrc/attention_f32.cuh``).  bf16: K_h and V_h with rows rounded up
    to 16, plus one 16-row Q tile per warp.  f32: the block's query rows
    (:func:`f32_resident_rows`), their f32 score rows and K_h, V_h, rows
    rounded up to 4."""
    if itemsize == 2:
        s16 = -(-s // 16) * 16
        return 2 * s16 * hd * 2 + _tc_warps(s, hd) * 16 * hd * 2
    return _f32_resident_bytes(s, hd, f32_resident_rows(s, hd))


def qtiled_smem_bytes(s: int, hd: int, itemsize: int) -> int:
    """Dynamic shared memory of one kernel-2 block (mirrors
    ``qtiled_smem_bytes`` in the CUDA source and
    ``f32attn::streamed_smem_bytes``).  bf16: 32 query rows' f32 score and
    query rows, plus one padded K/V tile.  f32: the tile of
    :func:`f32_streamed_tile`."""
    if itemsize == 2:
        return _Q_TILE * (s + hd) * 4 + _K_TILE * _padded_ld(hd, itemsize) * itemsize
    return _f32_streamed_bytes(s, hd, *f32_streamed_tile(s, hd))


def _shape_ok(q, k, v, num_heads) -> bool:
    """What every kernel needs besides shared memory."""
    if q.ndim != 3 or q.shape != k.shape or k.shape != v.shape:
        return False
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        return False
    b, s, d = q.shape
    if s < 1 or not (1 <= b <= _MAX_GRID_Z) or num_heads < 1 or d % num_heads:
        return False
    return d // num_heads in HEAD_DIMS


def supported_whole_row(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int) -> bool:
    """Whether kernel 1 takes this call: one head's K_h and V_h fit a block."""
    if not _shape_ok(q, k, v, num_heads):
        return False
    s, d = q.shape[1], q.shape[2]
    return smem_bytes(s, d // num_heads, q.element_size()) <= SMEM_LIMIT_BYTES


def supported_qtiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int) -> bool:
    """Whether kernel 2 takes this call: 32 query rows' scores fit a block."""
    if not _shape_ok(q, k, v, num_heads):
        return False
    s, d = q.shape[1], q.shape[2]
    return qtiled_smem_bytes(s, d // num_heads, q.element_size()) <= SMEM_LIMIT_BYTES


def supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int, *, mask: Optional[torch.Tensor] = None) -> bool:
    """Whether :func:`short_attention` takes this call on the card: kernel 1
    fits, or kernel 2 does (as the JAX gate covers both modes)."""
    if mask is not None:
        return False
    return (supported_whole_row(q, k, v, num_heads)
            or supported_qtiled(q, k, v, num_heads))


def supported_packed(qkv: torch.Tensor, num_heads: int) -> bool:
    """Whether kernel 3 takes this packed ``[B, S, 3D]`` slab: whole-row
    only, like the JAX gate (a longer sequence splits and takes kernel 2)."""
    if qkv.ndim != 3 or qkv.shape[2] % 3:
        return False
    q = qkv[..., : qkv.shape[2] // 3]
    return supported_whole_row(q, q, q, num_heads)


def short_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, num_heads: int,
                              causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernels 1 and 2: f32 logits, whole-row
    softmax, probabilities rounded to the input dtype, f32 P.V
    accumulation."""
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


def short_attention_packed_reference(qkv: torch.Tensor, num_heads: int,
                                     causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel 3: split the slab, then
    :func:`short_attention_reference`."""
    q, k, v = qkv.chunk(3, dim=-1)
    return short_attention_reference(q, k, v, num_heads, causal)


class _PlainVJP(torch.autograd.Function):
    """A kernel's output, with the VJP of its plain version as the backward
    (recomputed from the saved inputs)."""

    @staticmethod
    def forward(ctx, kernel, plain, num_heads, causal, *inputs):
        ctx.save_for_backward(*inputs)
        ctx.plain, ctx.args = plain, (num_heads, causal)
        return kernel(*inputs, num_heads, causal)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            out = ctx.plain(*leaves, *ctx.args)
            grads = torch.autograd.grad(out, leaves, grad)
        return (None, None, None, None, *grads)


def _differentiable(kernel, plain, num_heads, causal, *inputs):
    """``kernel(*inputs, num_heads, causal)``, through :class:`_PlainVJP`
    when autograd needs its gradient."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return _PlainVJP.apply(kernel, plain, num_heads, causal, *inputs)
    return kernel(*inputs, num_heads, causal)


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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"short_attention runs on cuda or cpu, not {q.device}")


def _refuse(name, shape, dtype, num_heads, gate):
    raise ValueError(
        f"the CUDA {name} kernel does not take {tuple(shape)} {dtype} "
        f"heads={num_heads} (see {gate}())"
    )


def _need_contiguous(name, *tensors):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")


def _need_aligned(name, *tensors, dtypes=(torch.bfloat16,)):
    """A kernel copies 16-byte chunks of inputs of these dtypes with
    ``cp.async`` (kernels 1 and 3 in both dtypes, kernel 2 in f32, the flash
    kernels 4-6 in both dtypes): a base pointer off a 16-byte boundary (a
    view whose storage offset is not a multiple of 16 bytes) would fault, so
    it raises here."""
    if any(t.dtype in dtypes and t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs 16-byte aligned inputs")


def _whole_row(q, k, v, num_heads, causal):
    _need_contiguous("short_attention", q, k, v)
    _need_aligned("short_attention", q, k, v, dtypes=_CP_ASYNC_DTYPES)
    out = torch.empty_like(q)
    b, s, d = q.shape
    cuda_build.launch("short_attention", "short_attention_forward", (q, k, v, out),
                      (b, s, d, num_heads, int(causal), _DTYPE_CODES[q.dtype]), q.device)
    short_attention.launches += 1
    return out


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, *, causal: bool = False) -> torch.Tensor:
    """q/k/v ``[B, S, D]`` merged-head -> ``[B, S, D]``.

    CPU tensors take :func:`short_attention_reference`.  CUDA tensors launch
    kernel 1 when :func:`supported_whole_row` holds (counted in
    ``short_attention.launches``), else kernel 2 through
    :func:`short_attention_qtiled` when :func:`supported_qtiled` holds, else
    raise."""
    _check(q, k, v, num_heads)
    if q.device.type == "cpu":
        return short_attention_reference(q, k, v, num_heads, causal)
    if supported_whole_row(q, k, v, num_heads):
        return _differentiable(_whole_row, short_attention_reference, num_heads,
                               causal, q, k, v)
    if supported_qtiled(q, k, v, num_heads):
        return short_attention_qtiled(q, k, v, num_heads, causal=causal)
    _refuse("short_attention", q.shape, q.dtype, num_heads, "supported")


short_attention.launches = 0


def _qtiled(q, k, v, num_heads, causal):
    _need_contiguous("short_attention_qtiled", q, k, v)
    _need_aligned("short_attention_qtiled", q, k, v, dtypes=(torch.float32,))
    out = torch.empty_like(q)
    b, s, d = q.shape
    cuda_build.launch("short_attention_qtiled", "short_attention_qtiled_forward",
                      (q, k, v, out), (b, s, d, num_heads, int(causal),
                                       _DTYPE_CODES[q.dtype]), q.device)
    short_attention_qtiled.launches += 1
    return out


def short_attention_qtiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int, *, causal: bool = False) -> torch.Tensor:
    """Kernel 2: q/k/v ``[B, S, D]`` merged-head -> ``[B, S, D]`` through
    q tiles with K/V streamed through shared memory.

    CPU tensors take :func:`short_attention_reference` (the same math);
    CUDA tensors launch kernel 2 (counted in ``short_attention_qtiled.launches``)
    or raise where :func:`supported_qtiled` does not hold."""
    _check(q, k, v, num_heads)
    if q.device.type == "cpu":
        return short_attention_reference(q, k, v, num_heads, causal)
    if not supported_qtiled(q, k, v, num_heads):
        _refuse("short_attention_qtiled", q.shape, q.dtype, num_heads,
                "supported_qtiled")
    return _differentiable(_qtiled, short_attention_reference, num_heads, causal,
                           q, k, v)


short_attention_qtiled.launches = 0


def _packed(qkv, num_heads, causal):
    _need_contiguous("short_attention_packed", qkv)
    _need_aligned("short_attention_packed", qkv, dtypes=_CP_ASYNC_DTYPES)
    b, s, d3 = qkv.shape
    out = qkv.new_empty(b, s, d3 // 3)
    cuda_build.launch("short_attention", "short_attention_packed_forward", (qkv, out),
                      (b, s, d3 // 3, num_heads, int(causal), _DTYPE_CODES[qkv.dtype]),
                      qkv.device)
    short_attention_packed.launches += 1
    return out


def short_attention_packed(qkv: torch.Tensor, num_heads: int, *,
                           causal: bool = False) -> torch.Tensor:
    """Kernel 3: packed qkv ``[B, S, 3D]`` (q | k | v along the last axis,
    the fused in-projection's output) -> ``[B, S, D]``.

    CPU tensors take :func:`short_attention_packed_reference`; CUDA tensors
    launch kernel 3 (counted in ``short_attention_packed.launches``) or raise
    where :func:`supported_packed` does not hold."""
    if qkv.ndim != 3 or qkv.shape[2] % 3 or (qkv.shape[2] // 3) % num_heads:
        raise ValueError(
            f"short_attention_packed takes [B, S, 3D] with D divisible by "
            f"{num_heads} heads, got {tuple(qkv.shape)}"
        )
    if qkv.device.type == "cpu":
        return short_attention_packed_reference(qkv, num_heads, causal)
    if qkv.device.type != "cuda":
        raise ValueError(f"short_attention_packed runs on cuda or cpu, not {qkv.device}")
    if not supported_packed(qkv, num_heads):
        _refuse("short_attention_packed", qkv.shape, qkv.dtype, num_heads,
                "supported_packed")
    return _differentiable(_packed, short_attention_packed_reference, num_heads,
                           causal, qkv)


short_attention_packed.launches = 0
