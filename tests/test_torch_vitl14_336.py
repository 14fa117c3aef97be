"""CLIP ViT-L/14@336px through the port's extraction path, against the
benchmark's plain float32 reference (``portbench/reference/clip_f32.py``),
and the per-block spans of ``models/layers.py::ResidualAttentionBlock``.

On the CPU the tower keeps ViT-L/14@336px's patch (14) and an odd patch
grid (resolution 42: 3 x 3 patches and the class token) at width 64, two
layers and one head of 64, and the 218 x 178 CelebA images upsample as the
benchmark's CelebA cells do.  The configuration at its published widths is
checked on the meta device against the port's state dict.  On a card,
``chip_smoke.py --only vitl14_336_bf16`` holds kernel 1 at the image tower's
shape against the plain formulation and counts one published-width batch's
launches.  Nothing here imports JAX.
"""

import json
import os

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from debiasing_multi_modal_tpu_torch.extract.runner import ZS_TEMPERATURE, ExtractionRunner
from debiasing_multi_modal_tpu_torch.models.config import CONFIGS
from debiasing_multi_modal_tpu_torch.utils import profiling
from portbench.core.clip_weights import clip_layout, make_state_dict
from portbench.core.inputs import image_pool, prompt_tokens
from portbench.loops.extract import build_model, port_config
from portbench.reference import clip_f32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SEED = 2147483911  # past 32 signed bits, as the benchmark's seeds are


def _published():
    with open(os.path.join(ROOT, "portbench", "configs", "clip-vit-l14-336.json")) as f:
        return json.load(f)


def _scaled():
    """ViT-L/14@336px's patch and its odd grid, at CPU widths, in f32."""
    return dict(_published(), image_resolution=42, vision_layers=2, vision_width=64,
                vision_heads=1, embed_dim=32, context_length=16, transformer_width=64,
                transformer_heads=1, transformer_layers=2, compute_dtype="float32")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)


def test_published_config_is_the_ports_and_its_layout():
    cfg = _published()
    port = CONFIGS["ViT-L/14@336px"].with_dtype(torch.bfloat16)
    assert port_config(cfg) == port
    assert (port.vision_heads, cfg["image_resolution"] // cfg["vision_patch_size"]) == (16, 24)
    from debiasing_multi_modal_tpu_torch.models.clip import CLIP

    with torch.device("meta"):
        model = CLIP(port)
    ours = {k: tuple(shape) for k, (shape, _) in clip_layout(cfg).items()}
    assert ours == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours["visual.positional_embedding"] == (577, 1024)
    params = sum(int(np.prod(s)) for s in ours.values() if s)
    assert 427e6 < params < 429e6  # ~428 M: 1.7 GB in f32, whole on one card


def test_extraction_matches_the_plain_reference_in_f32():
    cfg = _scaled()
    model = build_model(cfg, SEED, CPU)
    sd = make_state_dict(cfg, SEED, CPU)
    tokens = prompt_tokens(SEED, {"class": 3, "spurious": 2}, cfg["context_length"],
                           cfg["vocab_size"])
    with torch.no_grad():
        text = {k: model.encode_text(torch.from_numpy(v)).numpy() for k, v in tokens.items()}
        ref_text = {k: clip_f32.encode_text(torch.from_numpy(v), sd, cfg).numpy()
                    for k, v in tokens.items()}
    pool = image_pool(SEED, 3, 6, 218, 178, CPU)  # CelebA's aligned size: 218 x 178 -> 51 x 42
    metas = [{"filenames": np.asarray([f"b{b}_{i}" for i in range(6)]),
              **{k: np.zeros(6, np.int32) for k in ("y", "place", "group", "split")}}
             for b in range(3)]
    table = ExtractionRunner(model, text["class"]).run(zip(pool, metas), prefetch_depth=2,
                                                       upload_depth=2, max_in_flight=2)
    images = torch.from_numpy(pool.reshape(-1, 218, 178, 3))
    with torch.no_grad():
        ref_emb = clip_f32.encode_image(clip_f32.preprocess(images, 42), sd, cfg).numpy()
    # The port resizes by two f32 matmuls with the crop folded in, the
    # reference by F.interpolate's antialiased bilinear, and the two towers
    # sum in different orders: both are f32 rounding, which reads 0.5-1.2e-6
    # of the embedding's norm over four seeds; 2e-5 leaves room for other
    # CPUs' summation orders and is far below a bf16 rounding (~4e-3).
    assert _rel(table.embeddings, ref_emb).max() < 2e-5
    for k in tokens:  # the same ids through the same f32 operations (reads 0)
        assert _rel(text[k], ref_text[k]).max() < 1e-6
    # the zero-shot head: the reference's argmax, but where its two best
    # logits lie closer than the embeddings' gap could move them
    logits = clip_f32.zero_shot_logits(torch.from_numpy(ref_emb),
                                       torch.from_numpy(ref_text["class"]), ZS_TEMPERATURE)
    top2 = logits.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]).numpy() > 1e-2
    assert clear.sum() >= len(clear) - 1
    assert np.array_equal(table.y_pred[clear], logits.argmax(1).numpy()[clear])


def _block_spans(fn):
    n0 = len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return [s for s in profiling.spans()[n0:] if s.name.startswith("block.")]


def test_one_forward_records_two_block_spans_a_layer_per_tower():
    cfg = _scaled()
    model = build_model(cfg, SEED, CPU)
    images = torch.rand(2, 42, 42, 3, generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(prompt_tokens(SEED, {"class": 2}, 16, cfg["vocab_size"])["class"])
    with torch.no_grad():
        plain = model.encode_image(images)
        for encode, x, layers in ((model.encode_image, images, cfg["vision_layers"]),
                                  (model.encode_text, ids, cfg["transformer_layers"])):
            got = _block_spans(lambda: encode(x))
            assert [s.name for s in got] == ["block.attention", "block.mlp"] * layers
            for a, m in zip(got[::2], got[1::2]):
                assert a.start_ns <= a.end_ns <= m.start_ns <= m.end_ns
            assert all(s.device_ms is None for s in got)  # no card: no device time
        out = {}
        traced = _block_spans(lambda: out.setdefault("emb", model.encode_image(images)))
    assert len(traced) == 2 * cfg["vision_layers"]
    assert torch.equal(out["emb"], plain)  # tracing changes no output bit


def test_block_spans_are_the_shared_no_op_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function opened with tracing off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert profiling.annotate("block.attention", device=True) is profiling.annotate("block.mlp",
                                                                                    device=True)
    model = build_model(_scaled(), SEED, CPU)
    n0 = len(profiling.spans())
    with torch.no_grad():
        model.encode_image(torch.rand(1, 42, 42, 3))
    assert len(profiling.spans()) == n0
