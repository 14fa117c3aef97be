"""Device selection and the f32 precision guard for the port's public entry
points.

Entry points run on ``cuda`` unless the caller asks for the CPU: a missing
card is an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def compute_dtype(device: torch.device) -> torch.dtype:
    """The numerics policy: bf16 compute on the card, f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x.float()``, except that float64 stays float64: the f32 casts of
    Stage B (``models/adapter.py``, ``train/losses.py``) go through it, so a
    float64 run (the dry run's identity check, ``parallel/dryrun.py``) stays
    in float64 while every f32 result is the same bits as ``x.float()``."""
    return x if x.dtype == torch.float64 else x.float()


def on_device(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` lives on ``device`` (``cuda`` matches any card index)."""
    return t.device.type == device.type and device.index in (None, t.device.index)


@contextlib.contextmanager
def full_f32():
    """f32 products and convolutions at full f32 precision inside the region,
    whatever the process-wide TF32 switches say (PyTorch leaves cuDNN's on):
    the JAX reference computes these in exact f32, and TF32 keeps 10
    mantissa bits.  Restores both switches on exit.  The switches are
    process-wide, so a thread that runs CUDA work beside the region sees
    them off too."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
