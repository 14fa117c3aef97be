"""Ulysses sequence parallelism: the all-to-all exchange of the sequence and
head axes (port of ``ops/ulysses_attention.py``).

Inputs arrive sequence-sharded ``[B, S/n, H, D]``; one ``all_to_all_single``
scatters the heads and gathers the sequence (``[B, S, H/n, D]``), so each
rank holds the whole sequence for its heads and runs the port's plain
attention on them (``ops/attention.py::_xla_attention``, as the JAX module
calls XLA's); the reverse exchange restores ``[B, S/n, H, D]``.  The
exchange is a permutation, so the result is the plain attention's.  Its
gradient is the same exchange of the gradients
(``parallel/collectives.all_to_all``).  Needs ``heads % n == 0``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from debiasing_multi_modal_tpu_torch.ops.attention import _xla_attention
from debiasing_multi_modal_tpu_torch.ops.ring_attention import _check, sharded_call
from debiasing_multi_modal_tpu_torch.parallel.collectives import all_to_all
from debiasing_multi_modal_tpu_torch.parallel.mesh import axis_size


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """``[B, S/n, H, D]`` -> ``[B, S, H/n, D]``."""
    n = dist.get_world_size(group)
    b, sl, h, d = x.shape
    blocks = x.reshape(b, sl, n, h // n, d).permute(2, 0, 1, 3, 4)  # [n, B, S/n, H/n, D]
    got = all_to_all(blocks.contiguous(), group)  # block j: rank j's sequence chunk
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * sl, h // n, d)


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """``[B, S, H/n, D]`` -> ``[B, S/n, H, D]``."""
    n = dist.get_world_size(group)
    b, s, hl, d = x.shape
    blocks = x.reshape(b, n, s // n, hl, d).permute(1, 0, 2, 3, 4)  # [n, B, S/n, H/n, D]
    got = all_to_all(blocks.contiguous(), group)  # block j: rank j's heads
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hl, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                      causal: bool = False) -> torch.Tensor:
    """Ulysses attention over local chunks ``[B, S_local, H, D]`` (the
    global sequence is the group's chunks in rank order; ``H`` divisible by
    the group size); returns the local output chunk."""
    qg, kg, vg = (_seq_to_heads(x, group) for x in (q, k, v))
    return _heads_to_seq(_xla_attention(qg, kg, vg, causal=causal), group)


def ulysses_sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                        *, mesh, axis_name: str, causal: bool = False,
                                        batch_axis: Optional[str] = None) -> torch.Tensor:
    """Ulysses attention on global ``[B, S, H, D]`` inputs, mirroring
    ``sequence_parallel_attention``; returns the global output."""
    _check(q, k, v, mesh, axis_name, batch_axis, "ulysses attention")
    n = axis_size(mesh, axis_name)
    if q.shape[2] % n:
        raise ValueError(
            f"heads {q.shape[2]} must be divisible by the '{axis_name}' "
            f"axis size {n}"
        )
    return sharded_call(lambda a, b, c, g: ulysses_attention(a, b, c, g, causal),
                        q, k, v, mesh, axis_name, batch_axis)
