"""The extraction runner's upload and step (debiasing_multi_modal_tpu_torch/
extract/runner.py) and what a training step asks of the host.

On the CPU: ``completed_batches`` against the JAX package's on one shard
directory, and an upload that stays a plain tensor.  On a card (the
``on_card`` tests, skipped here; run them with ``python -m pytest
--noconftest tests/test_torch_runner.py -k on_card``): the upload runs on a
side stream of its own with an event the step waits on, and neither one
``encode_batch_async`` on an uploaded batch nor one whole training step
(preprocess, forward, backward, SGD) makes the host wait for the card,
under ``torch.cuda.set_sync_debug_mode("error")``.  JAX is imported inside
the parity test only.
"""

import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu_torch.extract import runner as trunner
from debiasing_multi_modal_tpu_torch.models import CLIPConfig, create_clip

TINY_VIT = dict(name="tiny-vit", embed_dim=64, image_resolution=32, vision_layers=2,
                vision_width=128, vision_patch_size=16, transformer_width=128,
                transformer_heads=2, transformer_layers=2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _piece(rows):
    return {"filenames": np.array([f"f{i}" for i in range(rows)]),
            "y": np.zeros(rows, np.int32), "place": np.zeros(rows, np.int32),
            "group": np.zeros(rows, np.int32), "split": np.zeros(rows, np.int32),
            "y_pred": np.zeros(rows, np.int32),
            "embeddings": np.zeros((rows, 4), np.float32)}


def test_completed_batches_matches_jax(tmp_path):
    from debiasing_multi_modal_tpu.extract import runner as jrunner

    empty = str(tmp_path / "none")
    assert trunner.completed_batches(empty) == jrunner.completed_batches(empty) == 0
    shard_dir = str(tmp_path / "shards")
    for n_batches, rows in ((3, 12), (2, 7), (1, 4)):
        trunner._write_shard(shard_dir, _piece(rows), n_batches)
        assert trunner.completed_batches(shard_dir) == jrunner.completed_batches(shard_dir)
        assert trunner.completed_rows(shard_dir) == jrunner.completed_rows(shard_dir)
    assert trunner.completed_batches(shard_dir) == 6
    assert trunner.completed_rows(shard_dir) == 23


def test_upload_on_the_cpu_is_a_plain_tensor():
    model = create_clip(CLIPConfig(**TINY_VIT), device="cpu")
    runner = trunner.ExtractionRunner(model, np.ones((2, 64), np.float32))
    images = np.random.default_rng(0).integers(0, 256, (3, 40, 40, 3), dtype=np.uint8)
    up = runner.upload_batch(images)
    assert up.ready is None and up.rows == 3 and up.images.device.type == "cpu"
    assert np.array_equal(up.images.numpy(), images)
    emb, preds, rows = runner.encode_batch_async(up)
    emb2, preds2 = runner.encode_batch(images)
    assert rows == 3 and np.array_equal(emb.numpy(), emb2) and np.array_equal(preds, preds2)


def test_upload_runs_on_a_side_stream_on_card(card):
    """The copy is on the runner's upload stream with an event after it; the
    step waits on that event on the card and gives the embeddings of a batch
    copied on the compute stream, bit for bit."""
    model = create_clip(CLIPConfig(**TINY_VIT), dtype=torch.bfloat16, device="cuda")
    runner = trunner.ExtractionRunner(model, np.ones((2, 64), np.float32))
    images = np.random.default_rng(1).integers(0, 256, (16, 40, 40, 3), dtype=np.uint8)
    up = runner.upload_batch(images)
    assert up.images.device.type == "cuda" and isinstance(up.ready, torch.cuda.Event)
    assert runner._upload_stream != torch.cuda.current_stream()
    emb, preds, _ = runner.encode_batch_async(up)
    plain = trunner.UploadedBatch(torch.from_numpy(images).cuda(), 16)
    emb2, preds2, _ = runner.encode_batch_async(plain)
    torch.cuda.synchronize()
    assert up.ready.query()
    assert torch.equal(emb, emb2) and torch.equal(preds, preds2)


def test_step_and_training_step_make_no_host_sync_on_card(card):
    """One ``encode_batch_async`` on an uploaded batch and one whole
    training step (preprocess, forward through kernels 4, backward through
    kernels 5 and 6, SGD) run under ``set_sync_debug_mode("error")``."""
    import torch.nn.functional as F

    from debiasing_multi_modal_tpu_torch.ops import flash_attention as fa
    from debiasing_multi_modal_tpu_torch.ops.preprocess import preprocess_uint8

    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (8, 40, 40, 3), dtype=np.uint8)
    model = create_clip(CLIPConfig(**TINY_VIT), dtype=torch.bfloat16, device="cuda",
                        attn_impl="pallas")
    runner = trunner.ExtractionRunner(model, np.ones((2, 64), np.float32))
    up = runner.upload_batch(images)
    tokens = torch.zeros(8, 77, dtype=torch.long)
    tokens[:, 0], tokens[:, 1:6], tokens[:, 6] = 49406, torch.arange(1, 6), 49407
    tokens, labels = tokens.cuda(), torch.arange(8, device="cuda")
    u8 = up.images
    model.requires_grad_(True)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        imgs = preprocess_uint8(u8, 32, dtype=torch.bfloat16)
        per_image, per_text = model(imgs, tokens)
        ((F.cross_entropy(per_image, labels) + F.cross_entropy(per_text, labels)) / 2
         ).backward()
        opt.step()

    step()  # first use builds the kernels and the preprocess constants
    runner.encode_batch_async(up)
    torch.cuda.synchronize()
    before = fa.flash_attention_dq.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        runner.encode_batch_async(up)
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert fa.flash_attention_dq.launches == before + 4  # 2 image + 2 text blocks
    assert all(torch.isfinite(p).all() for p in model.parameters())
