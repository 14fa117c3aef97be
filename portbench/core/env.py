"""Where a run keeps its caches, what card it runs on, and what it must not
have loaded.

Every build and kernel cache goes to a fixed directory inside the checkout
(:data:`CACHE_DIR`), so the second run of a cell finds what the first built.
The port builds its CUDA libraries into ``debiasing_multi_modal_tpu_torch/
build/``, which is inside the checkout too.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE_DIR = os.path.join(ROOT, ".portbench_cache")
PORT_PACKAGE = "debiasing_multi_modal_tpu_torch"
# top-level module names that may not be loaded in a run, compared whole:
# the port's own name begins with the JAX package's
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "debiasing_multi_modal_tpu")


class NoCard(RuntimeError):
    """The run asks for more CUDA cards than the machine has."""


def pin_caches() -> None:
    """Point every cache a run may write at a fixed directory in the
    checkout, and keep libraries from loading JAX on their own."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded(modules=None) -> List[str]:
    """Forbidden top-level names present in ``modules`` (``sys.modules``)."""
    names = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN_MODULES))


def require_cards(chips: int) -> None:
    """Raise :class:`NoCard` unless ``chips`` CUDA cards are visible."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs on CUDA cards only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, the machine has "
                     f"{torch.cuda.device_count()}")


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {type(err).__name__}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def device_info(chips: int, memory_peak_bytes: int) -> Dict[str, object]:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(memory_peak_bytes), "power": power_limit()}
