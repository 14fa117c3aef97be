"""Device meshes and row sharding (port of ``parallel/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` over its devices and lets XLA
insert the collectives.  Here a mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group (one rank per card on NCCL, or CPU processes on gloo),
and the sharded code calls the collectives itself:

- :func:`make_mesh` builds the mesh (``("data",)`` by default; ``("data",
  "model")`` for tensor parallelism);
- :func:`batch_rows` / :func:`gather_rows` are the counterparts of
  ``batch_sharding`` and ``replicated``: a rank's contiguous rows of a batch
  padded to the axis size, and the rows of every rank gathered back in rank
  order;
- :class:`RowShard` describes one rank's block of a row-sharded table
  (``train/loop.py::shard_bundle``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from debiasing_multi_modal_tpu_torch.utils.platform import DeviceLike, resolve_device


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",), device: DeviceLike = None):
    """A mesh over every rank of the default process group (which must be
    initialized: ``parallel/multihost.initialize``); ``shape`` defaults to
    all ranks on the first axis.  ``device`` names the device type (``cuda``
    unless the caller asks for the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.multihost.initialize() first")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != world or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} over axes {tuple(axis_names)} "
                         f"does not cover the {world} ranks")
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def _dim(mesh, axis: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh has no '{axis}' axis (its axes: {names})")
    return names.index(axis)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.size(_dim(mesh, axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(_dim(mesh, axis))


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(_dim(mesh, axis))


def pad_to_multiple(n: int, k: int) -> int:
    return -(-n // k) * k


def batch_rows(x, n: int, rank: int):
    """Rank ``rank``'s contiguous rows of ``x`` (numpy or torch), the batch
    padded to a multiple of ``n`` by repeating its last row (pad rows are
    dropped again by :func:`gather_rows`)."""
    b = x.shape[0]
    padded = pad_to_multiple(b, n)
    if padded != b:
        if isinstance(x, np.ndarray):
            x = np.concatenate([x, np.repeat(x[-1:], padded - b, axis=0)])
        else:
            x = torch.cat([x, x[-1:].expand(padded - b, *x.shape[1:])])
    per = padded // n
    return x[rank * per:(rank + 1) * per]


def gather_rows(local: torch.Tensor, group, rows: Optional[int] = None) -> torch.Tensor:
    """Every rank's ``local`` block (all of one shape) concatenated in rank
    order, the first ``rows`` kept."""
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local.contiguous(), group=group)
    out = torch.cat(parts)
    return out if rows is None else out[:rows]


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's block of a table of ``rows`` rows sharded over ``group``:
    rows ``[lo, lo + local)``, the last block padded."""

    group: object
    rows: int
    lo: int
    local: int

    @staticmethod
    def of(rows: int, group) -> "RowShard":
        n = dist.get_world_size(group)
        local = pad_to_multiple(max(rows, 1), n) // n
        return RowShard(group, rows, dist.get_rank(group) * local, local)

    def take(self, table: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full ``table``, zero-padded to ``local``."""
        block = table[self.lo:self.lo + self.local]
        if block.shape[0] < self.local:
            pad = table.new_zeros((self.local - block.shape[0],) + tuple(table.shape[1:]))
            block = torch.cat([block, pad])
        return block.contiguous()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole table from every rank's block."""
        return gather_rows(local, self.group, self.rows)

    def rows_of(self, idx: torch.Tensor, mask: torch.Tensor):
        """The local positions of global rows ``idx`` and ``mask`` narrowed to
        the rows this rank holds."""
        own = (idx >= self.lo) & (idx < min(self.lo + self.local, self.rows))
        return (idx - self.lo).clamp(0, self.local - 1), mask & own
