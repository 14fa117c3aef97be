"""A run loads neither JAX nor the JAX package, and a run without a card,
or without the program, prints no result."""

import os
import shutil
import subprocess
import sys

from portbench.core.env import forbidden_loaded
from portbench.tests.conftest import ROOT

PROBE = """
import sys
sys.path.insert(0, {root!r})
from portbench.tests.conftest import run_tiny
import portbench.run, portbench.calibrate
for kind in ("rn", "wb"):
    run_tiny(kind)
from portbench.core.env import forbidden_loaded
print("LOADED", forbidden_loaded())
print("PORT", "debiasing_multi_modal_tpu_torch" in sys.modules)
"""


def test_names_are_compared_whole():
    assert forbidden_loaded(["debiasing_multi_modal_tpu_torch.models.clip", "jaxtyping"]) == []
    assert forbidden_loaded(["debiasing_multi_modal_tpu.models", "jax.numpy"]) == [
        "debiasing_multi_modal_tpu", "jax"]


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT)], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout and "PORT True" in out.stdout


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "rn50-extract-celeba", "--seed", "5", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=cwd,
                          env={**os.environ, **(env or {})})


def test_no_card_no_result():
    out = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
