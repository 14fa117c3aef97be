"""Single-buffer parameter staging (port of ``parallel/packing.py``).

A CLIP state dict has hundreds of tensors; uploading them one by one pays a
copy per tensor.  :func:`pack_tree` lays every float tensor end to end in
ONE contiguous host buffer (bf16, or f32 with ``exact=True``), pinned when
it is bound for the card; :func:`unpack_tree` cuts the uploaded buffer back
into views and casts each to its leaf's dtype.  bf16 parameters pass
unchanged; f32 ones round to bf16 unless ``exact``.

Leaves are laid out in the state dict's order (the JAX package flattens its
pytree in sorted-key order, so the two buffers hold the same leaves in
different orders).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from debiasing_multi_modal_tpu_torch.utils.platform import DeviceLike, resolve_device

Spec = List[Tuple[str, Tuple[int, ...], torch.dtype, int, int]]


def pack_tree(tree: Mapping[str, object], exact: bool = False,
              pin: bool = False) -> Tuple[torch.Tensor, Spec]:
    """Host side: ``{name: tensor or array}`` -> (one 1-D buffer, spec of
    ``(name, shape, dtype, offset, size)`` per leaf).  Float leaves only:
    an integer routed through bf16 (or even f32) would be silently rounded."""
    leaves, spec, offset = [], [], 0
    for name, leaf in tree.items():
        t = torch.as_tensor(np.asarray(leaf) if not isinstance(leaf, torch.Tensor) else leaf)
        if not t.is_floating_point():
            raise TypeError(f"pack_tree supports float leaves only; {name} is {t.dtype} "
                            "(upload non-float leaves on their own)")
        leaves.append(t)
        spec.append((name, tuple(t.shape), t.dtype, offset, t.numel()))
        offset += t.numel()
    buf = torch.empty(offset, dtype=torch.float32 if exact else torch.bfloat16,
                      pin_memory=pin)
    for t, (_, _, _, off, size) in zip(leaves, spec):
        buf[off:off + size] = t.detach().reshape(-1).cpu().float()
    return buf, spec


def unpack_tree(buffer: torch.Tensor, spec: Spec) -> Dict[str, torch.Tensor]:
    """Device side: the packed buffer -> ``{name: tensor}``, views of the
    buffer where the leaf's dtype is the buffer's, else cast copies."""
    return {name: buffer[off:off + size].view(shape).to(dtype)
            for name, shape, dtype, off, size in spec}


def packed_host_init(name_or_config, seed: int = 0, device: DeviceLike = None,
                     **create_kwargs) -> Dict[str, torch.Tensor]:
    """Seeded CLIP weights drawn on the host and shipped to ``device``
    (``cuda`` unless the CPU is asked for) as one packed bf16 upload; returns
    the state dict there (non-float buffers uploaded as they are)."""
    from debiasing_multi_modal_tpu_torch.models.clip import create_clip

    dev = resolve_device(device)
    host = create_clip(name_or_config, device="cpu",
                       generator=torch.Generator().manual_seed(seed), **create_kwargs)
    sd = host.state_dict()
    floats = {k: v for k, v in sd.items() if v.is_floating_point()}
    buf, spec = pack_tree(floats, pin=dev.type == "cuda")
    out = unpack_tree(buf.to(dev, non_blocking=True), spec)
    out.update({k: v.to(dev) for k, v in sd.items() if not v.is_floating_point()})
    return out
