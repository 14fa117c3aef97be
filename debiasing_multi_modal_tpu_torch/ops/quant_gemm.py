"""int8 GEMM with a fused dequantization epilogue: the port of
``debiasing_multi_modal_tpu/ops/quant_gemm.py`` (kernel 7, ``_body``).

:func:`int8_matmul` computes ``((float(qx @ qk) * sx) * sk + bias)`` cast to
``out_dtype``, with the integer product exact and the last multiply and the
bias add fused into one rounding (:func:`dequantize`).  On a CUDA tensor it
launches the hand-written kernel in ``csrc/quant_gemm.cu`` (``wgmma`` int8
tensor cores fed by TMA through an ``mbarrier`` ring, int32 accumulators in
registers, the f32 epilogue before one coalesced output write) or raises;
on a CPU tensor it runs :func:`int8_matmul_reference`, the plain PyTorch
version.  There is no fall back from one to the other;
``int8_matmul.launches`` counts the kernel's launches.

The wrapper keeps the JAX wrapper's contract (``quant_gemm.py:78-99``): N a
multiple of 128, K padded with zeros to a multiple of 128
(:func:`pad_k_operands`; zeros add exact zeros, and TMA needs row strides
that are multiples of 16 bytes), ragged M (masked in the kernel, never
padded in device memory).  The kernel takes the weight as ``[N, K]``
(K-contiguous); a ``qk`` that is the transposed view of such a tensor, as
:func:`~debiasing_multi_modal_tpu_torch.ops.quant.int8_dense` makes from a
Linear weight, is passed without a copy.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from debiasing_multi_modal_tpu_torch.ops import cuda_build

K_MULTIPLE = 128  # K is zero-padded to this (the JAX wrapper's multiple; kBK in the kernel)
_N_TILE = 128  # output columns per block, kBN
_M_TILE = 128  # output rows per block, kBM
_MAX_GRID_Y = 65535
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(qx, qk, sx, sk, bias):
    if qx.ndim != 2 or qk.ndim != 2 or qx.shape[1] != qk.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(qx.shape)} @ {tuple(qk.shape)}")
    m, n = qx.shape[0], qk.shape[1]
    if qx.dtype != torch.int8 or qk.dtype != torch.int8:
        raise ValueError(f"qx and qk must be int8, got {qx.dtype} and {qk.dtype}")
    if n % _N_TILE:
        raise ValueError(
            f"N ({n}) must be a multiple of {_N_TILE}; every CLIP Dense output "
            "dim is — pad in the caller for other shapes"
        )
    if tuple(sx.shape) != (m, 1) or tuple(sk.shape) != (n,):
        raise ValueError(f"scales must be sx [{m}, 1] and sk [{n}], got "
                         f"{tuple(sx.shape)} and {tuple(sk.shape)}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be [{n}], got {tuple(bias.shape)}")
    tensors = [qx, qk, sx, sk] + ([] if bias is None else [bias])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("int8_matmul operands must lie on one device")


def dequantize(acc: torch.Tensor, sx: torch.Tensor, sk: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *,
               fused: bool = True) -> torch.Tensor:
    """The f32 epilogue of an exact integer product ``acc`` (any dtype that
    holds it exactly): ``(float(acc) * sx) * sk (+ bias)``.

    With ``fused`` the last multiply and the bias add round once, as
    ``fma(float(acc) * sx, sk, bias)``: kernel 7's epilogue, and what XLA
    makes of the JAX kernel's body.  Without it the bias add rounds on its
    own: the JAX package's ``xla`` impl.  (The two JAX impls differ there,
    by a few ulps where the bias add cancels; the port copies each.)  The
    fused step runs in float64, where the product of two f32 values is
    exact, so only the sum rounds before the cast back to f32."""
    a = acc.float() * sx.float()
    if bias is None:
        return a * sk.float()[None, :]
    if not fused:
        return a * sk.float()[None, :] + bias.float()[None, :]
    return (a.double() * sk.double()[None, :] + bias.double()[None, :]).float()


def int8_matmul_reference(qx: torch.Tensor, qk: torch.Tensor, sx: torch.Tensor,
                          sk: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          *, out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version, exact in the integer product: an int32 matmul
    on the CPU, float64 on the card (|acc| <= 127^2 * K < 2^53, so every
    partial sum is an exact integer), then :func:`dequantize`."""
    if qx.device.type == "cpu":
        acc = qx.to(torch.int32) @ qk.to(torch.int32)
    else:
        acc = qx.double() @ qk.double()
    return dequantize(acc, sx, sk, bias).to(out_dtype)


def pad_k_operands(qx: torch.Tensor, qk: torch.Tensor):
    """``(qx [M, Kp], qkT [N, Kp])``, both contiguous, with K zero-padded to
    a multiple of :data:`K_MULTIPLE`: the kernel's operands.  Zero columns
    of qx meet zero rows of qk, so the integer product is unchanged (only
    the ViT-L/14 patch GEMM, K = 588, pads)."""
    qkt = qk.t()  # [N, K]: the kernel's K-contiguous weight layout
    pad = -qx.shape[1] % K_MULTIPLE
    if pad:
        qx, qkt = F.pad(qx, (0, pad)), F.pad(qkt, (0, pad))
    return qx.contiguous(), qkt.contiguous()


def _need(cond, msg):
    if not cond:
        raise ValueError(msg)


def int8_matmul(qx: torch.Tensor, qk: torch.Tensor, sx: torch.Tensor,
                sk: torch.Tensor, bias: Optional[torch.Tensor] = None,
                *, out_dtype=torch.float32) -> torch.Tensor:
    """qx ``[M, K]`` int8, qk ``[K, N]`` int8, sx ``[M, 1]`` f32 per-row
    scales, sk ``[N]`` f32 per-column scales, optional bias ``[N]`` f32 ->
    ``[M, N]`` of ``out_dtype`` (f32 or bf16 on the card)."""
    _check(qx, qk, sx, sk, bias)
    if qx.device.type == "cpu":
        return int8_matmul_reference(qx, qk, sx, sk, bias, out_dtype=out_dtype)
    _need(qx.device.type == "cuda", f"int8_matmul runs on cuda or cpu, not {qx.device}")
    _need(out_dtype in _OUT_CODES, f"the CUDA int8_matmul writes f32 or bf16, not {out_dtype}")
    m, n = qx.shape[0], qk.shape[1]
    _need(-(-m // _M_TILE) <= _MAX_GRID_Y, f"M={m} exceeds the kernel's grid")
    for name, t in (("sx", sx), ("sk", sk), ("bias", bias)):
        _need(t is None or (t.dtype == torch.float32 and t.is_contiguous()),
              f"{name} must be a contiguous f32 tensor")
    qx, qkt = pad_k_operands(qx, qk)
    _need(qx.data_ptr() % 16 == 0 and qkt.data_ptr() % 16 == 0,
          "int8_matmul needs 16-byte aligned qx and qk (TMA)")
    out = torch.empty(m, n, device=qx.device, dtype=out_dtype)
    cuda_build.launch("quant_gemm", "int8_matmul_forward", (qx, qkt, sx, sk, bias, out),
                      (m, n, qx.shape[1], _OUT_CODES[out_dtype]), qx.device)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
