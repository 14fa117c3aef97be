"""Device selection for the port's public entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU: a missing
card is an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

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
