"""Fixtures of the benchmark's own tests (``python -m pytest portbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and skip through the
``card`` fixture, which looks for a card when the test runs, never when a
module is imported.  Tiny configurations and traffic let the loops run on
the CPU in a few seconds.
"""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_RN = {"name": "tiny-rn", "port_config": "tiny-rn", "embed_dim": 32, "image_resolution": 64,
           "vision_layers": [1, 1, 1, 1], "vision_width": 8, "vision_patch_size": None,
           "vision_heads": 4, "context_length": 16, "vocab_size": 49408,
           "transformer_width": 32, "transformer_heads": 2, "transformer_layers": 2,
           "compute_dtype": "bfloat16", "zero_shot_temperature": 0.02}
TINY_VIT = dict(TINY_RN, name="tiny-vit", port_config="tiny-vit", vision_layers=2,
                vision_width=64, vision_patch_size=16, vision_heads=1)
TINY_EXTRACT = {"loop": "extract", "batch": 4, "height": 54, "width": 44, "pool_batches": 2,
                "warmup_batches": 2, "prefetch_depth": 2, "upload_depth": 2, "max_in_flight": 4,
                "prompts": {"class": 2, "spurious": 2, "group": 4}, "check_images": 64,
                "trace_batches": 2}
EXTRACT_LIMITS = {"emb_rel_err": 0.05, "text_rel_err": 0.05, "pred_mismatch": 0,
                  "ref_pred_mismatch": 0}
SWEEP_LIMITS = {"loss_gap": 1e-4, "grad_gap": 2e-6, "change_gap": 2e-6, "start_gap": 0.0}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the card with python -m pytest portbench/tests -m card")
    return torch.device("cuda", 0)


def tiny_sweep_traffic(kind: str) -> dict:
    import json

    name = "waterbirds-grid48" if kind == "wb" else "celeba-balanced-grid6"
    with open(os.path.join(ROOT, "portbench", "traffic", name + ".json")) as f:
        tr = json.load(f)
    tr["sizes"] = {"train": 300, "val": 160, "test": 100}
    tr["trace"]["steps"] = 3
    if kind == "wb":
        tr["grid"] = {"seeds": [42, 32], "lr": [1, 10], "bs": [32, 64], "bsr": [8, 16],
                      "lr_multiple": 1.0}
    else:
        tr["grid"]["bsr"] = [2, 4]
        tr["train"]["epochs"] = 3
    return tr


def run_tiny(kind: str, faults=(), seed: int = 2147483901, seconds: float = 0.5):
    """A loop run on the CPU at a tiny size: ``kind`` is rn, vit, wb or ca."""
    import torch

    from portbench.core.cell import Context
    from portbench.core.manifest import load_module

    if kind in ("rn", "vit"):
        cfg, tr, limits = (TINY_RN if kind == "rn" else TINY_VIT), TINY_EXTRACT, EXTRACT_LIMITS
        loop = "extract"
    else:
        cfg, tr, limits = dict(TINY_RN), tiny_sweep_traffic(kind), SWEEP_LIMITS
        loop = "sweep"
    module = load_module(os.path.join(ROOT, "portbench", "loops", loop + ".py"),
                         f"portbench.loops.{loop}")
    ctx = Context(workload="tiny-" + kind, seed=seed, seconds=seconds, config=cfg, traffic=tr,
                  limits=limits, device=torch.device("cpu"), t_start=time.perf_counter(),
                  faults=frozenset(faults))
    return module.run(ctx)
