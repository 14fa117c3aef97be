"""The port stands alone: in a fresh interpreter (this test process has jax
imported by tests/conftest.py), importing debiasing_multi_modal_tpu_torch and
running tiny CPU extractions — a ResNet, unfused and folded (``fuse_bn``,
with the bottleneck kernels' wrappers on one of its blocks), and a ViT
plain, with ``fuse_qkv`` (the packed attention path) and with both int8
modes — a contrastive
gradient step through a ViT CLIP on the flash path with ``remat``, a
two-epoch Stage-B ``train_all_epochs`` across the phase boundary with the
second adapter, a contrastive ``train_all_epochs`` with the linear head,
a two-seed stacked ``run_seeds``, a native clip.json write and load, a
pipelined stack on a one-rank group, the side modules (``ops.augment``,
``models.resnet_plain``, ``train.linear_eval``, ``weights.zoo``,
``viz.*``, ``utils.{timing,meters}``, ``data.predictions``, ``entry``),
and (on two launched gloo ranks, each checked too) a tensor-parallel
extraction, a seed-mesh sweep and a two-stage pipeline imports neither
``jax`` nor anything of
``debiasing_multi_modal_tpu``; importing the
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

from debiasing_multi_modal_tpu_torch.ops.conv_gemm import block_weights, fused_bottleneck_gemm
from debiasing_multi_modal_tpu_torch.ops.fused_bottleneck import fused_bottleneck
from debiasing_multi_modal_tpu_torch.weights.convert import clip_from_state_dict
from debiasing_multi_modal_tpu_torch.weights.fold import fold_resnet_bn
folded = clip_from_state_dict(fold_resnet_bn({k: v.numpy() for k, v in model.state_dict().items()}),
                              device="cpu", fuse_bn=True)
assert ExtractionRunner(folded, text).run(iter(batches)).embeddings.shape == (2, 32)
assert fused_bottleneck_gemm(torch.zeros(1, 8, 8, 16),
                             *block_weights(folded.visual.layer1[0])).shape == (1, 8, 8, 64)
assert fused_bottleneck(torch.zeros(1, 4, 4, 32), torch.zeros(32, 8), torch.zeros(8),
                        torch.zeros(3, 3, 8, 8), torch.zeros(8), torch.zeros(8, 32),
                        torch.zeros(32)).shape == (1, 4, 4, 32)
assert fused_bottleneck_gemm.launches == fused_bottleneck.launches == 0

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

from debiasing_multi_modal_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_dataset
from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
from debiasing_multi_modal_tpu_torch.train.loop import bundle_from_embedding_table, train_all_epochs
meta, emb_table, text_class, text_group, text_spurious = make_synthetic_dataset(
    SyntheticSpec(dim=16, n_train=64, n_val=32, n_test=32))
bundle = bundle_from_embedding_table(
    emb_table, {name: meta.take(np.where(meta.split == sid)[0])
                for name, sid in (("train", 0), ("val", 1), ("test", 2))},
    text_class, text_spurious, text_group, device="cpu")
cfg = TrainConfig(tl_method="adapter_reg_seq_alter", epochs=2, epochs_feature_learning=1,
                  add_adapter=True, input_dim=16, adapter_feat_dim=8, batch_size=32,
                  batch_size_reg=8)
_, _, history = train_all_epochs(cfg, bundle, verbose=False, device="cpu")
assert len(history["test"]) == 2
cfg = TrainConfig(tl_method="contrastive_adapter", epochs=2, input_dim=16, adapter_feat_dim=8,
                  batch_size=32, num_positive=4, num_negative=4, batch_factor=2,
                  ca_head="linear")
_, _, history = train_all_epochs(cfg, bundle, verbose=False, device="cpu")
assert len(history["cl_loss"]) == 2
from debiasing_multi_modal_tpu_torch.sweep.runner import run_seeds
cfg = TrainConfig(tl_method="adapter", epochs=2, input_dim=16, adapter_feat_dim=8, batch_size=32)
assert len(run_seeds(cfg, bundle, [42, 32], device="cpu")) == 2
import os, tempfile
from debiasing_multi_modal_tpu_torch.data.embeddings_store import load_embeddings, save_embeddings
from debiasing_multi_modal_tpu_torch.native import ebdjson
with tempfile.TemporaryDirectory() as tmp:
    save_embeddings(os.path.join(tmp, "clip.json"), emb_table, fmt="json")
    assert len(load_embeddings(os.path.join(tmp, "clip.json"))) == len(emb_table)
assert ebdjson.load_embeddings_json.calls == ebdjson.save_embeddings_json.calls == 1
from debiasing_multi_modal_tpu_torch import entry as entry_module
from debiasing_multi_modal_tpu_torch.data import predictions
from debiasing_multi_modal_tpu_torch.models.resnet_plain import PlainResNet
from debiasing_multi_modal_tpu_torch.ops.augment import train_augment
from debiasing_multi_modal_tpu_torch.parallel import multihost, pp
from debiasing_multi_modal_tpu_torch.parallel.mesh import make_mesh
from debiasing_multi_modal_tpu_torch.train.linear_eval import linear_probe
from debiasing_multi_modal_tpu_torch.utils import meters, timing
from debiasing_multi_modal_tpu_torch.viz import analysis, plots, umap_lite
from debiasing_multi_modal_tpu_torch.weights import zoo
assert callable(entry_module.entry) and callable(plots.plot_splits) and zoo.available_models()
with multihost.process_group("cpu"):
    mesh = make_mesh((1,), ("stage",), device="cpu")
    stacked, _ = pp.stack_block_params(create_clip(vit, device="cpu").transformer)
    assert pp.pipeline_transformer(stacked, torch.zeros(2, 8, 128), mesh=mesh, num_heads=2,
                                   microbatches=2).shape == (2, 8, 128)
assert train_augment(torch.Generator().manual_seed(0), torch.rand(2, 16, 16, 3),
                     out_res=8).shape == (2, 8, 8, 3)
with torch.no_grad():
    assert PlainResNet((1, 1, 1, 1), width=4)(torch.zeros(2, 32, 32, 3)).shape == (2, 128)
params, acc = linear_probe(np.eye(8, dtype=np.float32), np.arange(8) % 2, epochs=1,
                           batch_size=4, device="cpu")
assert params["w"].shape == (8, 2)
assert umap_lite.UMAP(n_epochs=2).fit_transform(rng.standard_normal((12, 4))).shape == (12, 2)
assert len(analysis.group_stats(rng.standard_normal((8, 4)), np.arange(8) % 4)) == 4
meter = meters.AverageMeter()
meter.update(1.0)
assert timing.measure_upload_ms(np.zeros(4, np.uint8), device="cpu") >= 0
with tempfile.TemporaryDirectory() as tmp:
    predictions.save_predictions(os.path.join(tmp, "p.csv"), ["a"], [1])
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import torch_parallel_worker
from debiasing_multi_modal_tpu_torch.parallel.multihost import launch
ranks_bad = launch(torch_parallel_worker.isolation, 2, timeout_s=240)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m == "debiasing_multi_modal_tpu"
             or m.startswith("debiasing_multi_modal_tpu."))
print(json.dumps({"after_import": after_import, "bad": bad, "ranks_bad": ranks_bad}))
"""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    assert result["ranks_bad"] == [[], []]
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


def test_packaging_names_the_port_clis_and_ships_every_kernel_source():
    """pyproject.toml installs a console script for each of the port's three
    CLIs, and its package data covers every file under csrc/ (the .cu
    sources include the .cuh headers, so an installed copy needs both)."""
    import fnmatch
    import importlib
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)
    port = {name: target for name, target in project["project"]["scripts"].items()
            if target.startswith("debiasing_multi_modal_tpu_torch.")}
    assert sorted(t.split(":")[0].rsplit(".", 1)[1] for t in port.values()) == [
        "extract_main", "sweep_main", "train_main"]
    for target in port.values():
        module, fn = target.split(":")
        assert callable(getattr(importlib.import_module(module), fn))
    patterns = project["tool"]["setuptools"]["package-data"]["debiasing_multi_modal_tpu_torch"]
    csrc = os.path.join(REPO, "debiasing_multi_modal_tpu_torch", "csrc")
    for name in os.listdir(csrc):
        assert any(fnmatch.fnmatch(f"csrc/{name}", p) for p in patterns), name
