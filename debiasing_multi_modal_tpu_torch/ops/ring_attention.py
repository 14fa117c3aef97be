"""Ring attention: sequence-parallel attention over a process group (port
of ``ops/ring_attention.py``).

Each rank holds one contiguous chunk of the sequence (q, k, v ``[B, S/n, H,
D]``), attends its q chunk to the kv chunk it currently holds, and passes
that kv chunk one hop around the ring (``batch_isend_irecv`` to the next
rank, from the previous one) while an online-softmax accumulator (acc, m,
l) merges the partial results: the flash recurrence across ranks, with no
rank ever holding the whole sequence.  The causal mask is computed from
global positions (chunk index x chunk length + offset), so it is exact.

:class:`_Ring` is a ``torch.autograd.Function`` whose backward is a second
ring, as the JAX package's custom VJP: k, v, dk and dv rotate together, so
each gradient lands back on its own rank after n hops, and each chunk's
exact softmax comes from the saved logsumexp; the rotated kv stream is
never saved.  The JAX module is plain XLA and calls no Pallas kernel, so
this one is plain f32 PyTorch arithmetic, not a kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from debiasing_multi_modal_tpu_torch.parallel.collectives import (
    gather_from_group,
    split_to_group,
)
from debiasing_multi_modal_tpu_torch.parallel.mesh import axis_group, axis_size

_NEG_INF = float(-1e30)


def _causal_add(sl: int, idx: int, src: int, device) -> torch.Tensor:
    q_pos = idx * sl + torch.arange(sl, device=device)
    kv_pos = src * sl + torch.arange(sl, device=device)
    keep = kv_pos[None, :] <= q_pos[:, None]  # [sq, skv]
    return torch.where(keep, 0.0, _NEG_INF)[None, None]


def _rotate(tensors, group, step: int = 1):
    """Every tensor one hop around the ring: sent to the next rank (the
    previous one for ``step=-1``), replaced by the previous rank's (the
    next one's)."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    rank = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (rank + step) % n)
    prv = dist.get_global_rank(group, (rank - step) % n)
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, o, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def ring_forward(q, k, v, group, causal: bool):
    """The forward ring; returns ``(out, lse)`` with ``lse = m + log(l)``
    of shape ``[B, H, S/n]``."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    b, sl, h, d = q.shape
    scale = d ** -0.5
    q32 = q.float() * scale
    acc = torch.zeros(b, sl, h, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sl), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, h, sl, dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for i in range(n):
        src = (idx - i) % n  # the global chunk the rotating kv currently is
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, kc.float())
        if causal:
            logits = logits + _causal_add(sl, idx, src, q.device)
        m_i = logits.amax(dim=-1)
        e = torch.exp(logits - m_i[..., None])
        l_i = e.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", e.to(vc.dtype).float(), vc.float())
        # the online softmax merge; m and l are [b, h, sq], acc [b, sq, h, d]
        m_new = torch.maximum(m, m_i)
        a_old, a_new = torch.exp(m - m_new), torch.exp(m_i - m_new)
        acc = acc * a_old.transpose(1, 2)[..., None] + pv * a_new.transpose(1, 2)[..., None]
        l = l * a_old + l_i * a_new
        m = m_new
        if i + 1 < n:
            kc, vc = _rotate((kc, vc), group)
    l = l.clamp_min(1e-30)  # fully masked rows (never in valid causal use)
    out = acc / l.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(l)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        out, lse = ring_forward(q, k, v, group, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        b, sl, h, d = q.shape
        scale = d ** -0.5
        q32, do32 = q.float(), dout.float()
        # delta_i = sum_d dout * out (the softmax normalization's pullback)
        delta = torch.einsum("bqhd,bqhd->bhq", do32, out.float())
        dq = torch.zeros_like(q32)
        kc, vc = k, v
        dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for i in range(n):
            src = (idx - i) % n
            logits = torch.einsum("bqhd,bkhd->bhqk", q32 * scale, kc.float())
            if causal:
                logits = logits + _causal_add(sl, idx, src, q.device)
            p = torch.exp(logits - lse[..., None])  # the exact softmax rows
            dvc = dvc + torch.einsum("bhqk,bqhd->bkhd", p, do32)
            dp = torch.einsum("bqhd,bkhd->bhqk", do32, vc.float())
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kc.float())
            dkc = dkc + torch.einsum("bhqk,bqhd->bkhd", ds, q32)
            # the gradient accumulators travel with their kv chunk; after n
            # hops each is back on its own rank
            if i + 1 < n:
                kc, vc, dkc, dvc = _rotate((kc, vc, dkc, dvc), group)
            else:
                dkc, dvc = _rotate((dkc, dvc), group)
        return dq.to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   causal: bool = False) -> torch.Tensor:
    """Ring attention over local chunks ``[B, S_local, H, D]`` (the global
    sequence is the group's chunks in rank order); returns the local output
    chunk in q's dtype.  Differentiable, memory-true in both passes."""
    return _Ring.apply(q, k, v, group, causal)


def _check(q, k, v, mesh, axis_name, batch_axis, what):
    if q.ndim != 4 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(
            f"{what} is self-attention over [B,S,H,D]; "
            f"got q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}"
        )
    n = axis_size(mesh, axis_name)
    if q.shape[1] % n:
        raise ValueError(
            f"global sequence {q.shape[1]} must be divisible by the "
            f"'{axis_name}' axis size {n}"
        )
    if batch_axis is not None and q.shape[0] % axis_size(mesh, batch_axis):
        raise ValueError(
            f"batch {q.shape[0]} must be divisible by the '{batch_axis}' axis size "
            f"{axis_size(mesh, batch_axis)}"
        )


def sharded_call(fn, q, k, v, mesh, axis_name: str, batch_axis: Optional[str]):
    """``fn(q, k, v, group)`` on this rank's chunk of the global ``[B, S, H,
    D]`` inputs (S over ``axis_name``, B over ``batch_axis``), the chunks'
    outputs gathered back into the global output.  Differentiable: the
    gradient of a replicated input is the unsharded one on every rank."""
    group = axis_group(mesh, axis_name)
    bgroup = axis_group(mesh, batch_axis) if batch_axis is not None else None

    def local(x):
        x = split_to_group(x, group, 1)
        return x if bgroup is None else split_to_group(x, bgroup, 0)

    out = fn(local(q), local(k), local(v), group)
    if bgroup is not None:
        out = gather_from_group(out, bgroup, 0)
    return gather_from_group(out, group, 1)


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                mesh, axis_name: str, causal: bool = False,
                                batch_axis: Optional[str] = None) -> torch.Tensor:
    """Ring attention on global (replicated) ``[B, S, H, D]`` inputs: the
    sequence is chunked over ``axis_name`` (S must divide), the batch over
    ``batch_axis`` if given (dp x sp: a ring per data slice); returns the
    global output."""
    _check(q, k, v, mesh, axis_name, batch_axis, "sequence_parallel_attention")
    return sharded_call(lambda a, b, c, g: ring_attention(a, b, c, g, causal),
                        q, k, v, mesh, axis_name, batch_axis)
