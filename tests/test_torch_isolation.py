"""The port stands alone: in a fresh interpreter (this test process has jax
imported by tests/conftest.py), importing debiasing_multi_modal_tpu_torch and
running tiny CPU extractions — a ResNet, and a ViT plain, with ``fuse_qkv``
(the packed attention path) and with both int8 modes — and a contrastive
gradient step through a ViT CLIP on the flash path with ``remat`` imports
neither ``jax`` nor anything of ``debiasing_multi_modal_tpu``; importing the
package alone imports no Triton and loads no kernel library."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, sys
import debiasing_multi_modal_tpu_torch
from debiasing_multi_modal_tpu_torch.ops import cuda_build
after_import = {"triton": "triton" in sys.modules, "libs": cuda_build.loaded()}

import numpy as np
import torch
from debiasing_multi_modal_tpu_torch.extract.runner import ExtractionRunner
from debiasing_multi_modal_tpu_torch.models import CLIPConfig, create_clip

cfg = CLIPConfig(name="tiny", embed_dim=32, image_resolution=64,
                 vision_layers=(1, 1, 1, 1), vision_width=16,
                 vision_patch_size=None, transformer_width=128,
                 transformer_heads=2, transformer_layers=1)
model = create_clip(cfg, device="cpu")
tokens = torch.zeros(2, 77, dtype=torch.int32)
tokens[:, 0], tokens[:, 3] = 49406, 49407
with torch.no_grad():
    text = model.encode_text(tokens).numpy()
rng = np.random.default_rng(0)
batches = [(rng.integers(0, 256, (2, 72, 96, 3), dtype=np.uint8),
            {"filenames": np.array(["a", "b"]), "y": np.zeros(2, np.int32),
             "place": np.zeros(2, np.int32), "group": np.zeros(2, np.int32),
             "split": np.zeros(2, np.int32)})]
table = ExtractionRunner(model, text).run(iter(batches))
assert table.embeddings.shape == (2, 32)

from debiasing_multi_modal_tpu_torch.ops.quant_gemm import int8_matmul
from debiasing_multi_modal_tpu_torch.ops.short_attention import short_attention_packed
vit = CLIPConfig(name="tiny-vit", embed_dim=32, image_resolution=32,
                 vision_layers=1, vision_width=128, vision_patch_size=16,
                 transformer_width=128, transformer_heads=2, transformer_layers=1)
for options in ({}, {"fuse_qkv": True}, {"quant": "int8"}, {"quant": "int8_pallas"}):
    model = create_clip(vit, device="cpu", **options)
    table = ExtractionRunner(model, text).run(iter(batches))
    assert table.embeddings.shape == (2, 32)
    with torch.no_grad():
        model.encode_text(tokens)
assert short_attention_packed(torch.zeros(1, 8, 384), 2).shape == (1, 8, 128)

from debiasing_multi_modal_tpu_torch.ops.flash_attention import flash_attention
train = create_clip(vit, device="cpu", attn_impl="pallas", remat=True).requires_grad_(True)
per_image, per_text = train(torch.randn(2, 32, 32, 3), tokens)
loss = torch.nn.functional.cross_entropy(per_image, torch.arange(2))
(loss + torch.nn.functional.cross_entropy(per_text, torch.arange(2))).backward()
assert all(p.grad is not None for p in train.parameters())
assert flash_attention.launches == 0
assert int8_matmul(torch.zeros(4, 64, dtype=torch.int8), torch.zeros(64, 128, dtype=torch.int8),
                   torch.ones(4, 1), torch.ones(128)).shape == (4, 128)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m == "debiasing_multi_modal_tpu"
             or m.startswith("debiasing_multi_modal_tpu."))
print(json.dumps({"after_import": after_import, "bad": bad}))
"""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    assert result["after_import"] == {"triton": False, "libs": []}


def test_port_sources_name_no_jax_import():
    pkg = os.path.join(REPO, "debiasing_multi_modal_tpu_torch")
    offenders = []
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                s = line.strip()
                if s.startswith(("import ", "from ")) and (
                    "jax" in s.split()[1] or "flax" in s.split()[1]
                    or s.split()[1].split(".")[0] == "debiasing_multi_modal_tpu"
                ):
                    offenders.append(f"{path}:{n}: {s}")
    assert offenders == []
