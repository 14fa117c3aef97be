"""Three faults of the port against the JAX reference, each pinned by a test.

1. f32 convolutions on the card followed cuDNN's process-wide TF32 switch,
   which PyTorch leaves on: an f32 ResNet tower (``models/resnet.py``
   ``_conv``) and ``ops/conv_gemm.py::xla_bottleneck`` now convolve under
   ``utils/platform.full_f32``.  On the CPU the test records the switch as
   each ``F.conv2d`` sees it; on a card (``on_card``, skipped here; run with
   ``python -m pytest --noconftest tests/test_torch_faults.py -k on_card``)
   an f32 RN50 tower, with the global switches left at PyTorch's defaults,
   agrees with the CPU within 1e-5 of scale (TF32 convolutions put it
   ~4e-4 away, inside the 1e-3 limit for f32 towers).
2. Two Stage-A paths no port test ran: the CelebA layout (the extraction
   CLI's default ``--dataset``), through both packages' CLIs on one tiny
   synthetic CelebA tree, caches held to each other; and ``--checkpoint``:
   an archive the port's ``save_jit_state_dict_archive`` writes (the JAX
   package's reads the same, ``tests/test_torch_leaves.py``), read alike by
   both packages, and the weights both CLIs extract with in the CelebA
   test.
3. The tokenizer searches fewer places for the merges file than the JAX
   package's, by design: it searches ``$CLIP_BPE_PATH``, its own assets
   directory and ``~/.cache/clip``, and never the JAX package's absolute
   location outside the checkout and HOME.  The test holds the two lists to
   that documented difference.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from debiasing_multi_modal_tpu_torch.models import CLIPConfig, create_clip
from debiasing_multi_modal_tpu_torch.ops import conv_gemm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_RN = dict(name="small-rn", embed_dim=64, image_resolution=64, vision_layers=(1, 1, 1, 1),
                vision_width=16, vision_patch_size=None, transformer_width=128,
                transformer_heads=2, transformer_layers=1)


def _close(ours, ref, rel):
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


@pytest.fixture
def synthetic_bpe(tmp_path, monkeypatch):
    """test_torch_extract.py's synthetic merges file for both tokenizers;
    imported here, so that the card machine (no JAX) collects this file."""
    from debiasing_multi_modal_tpu.tokenizer import bpe as jbpe
    from debiasing_multi_modal_tpu_torch.tokenizer import bpe as tbpe
    from test_torch_extract import _write_merges

    path = str(tmp_path / "bpe_simple_vocab_16e6.txt.gz")
    _write_merges(path)
    monkeypatch.setenv("CLIP_BPE_PATH", path)
    jbpe.default_tokenizer.cache_clear()
    tbpe.default_tokenizer.cache_clear()
    yield path
    jbpe.default_tokenizer.cache_clear()
    tbpe.default_tokenizer.cache_clear()


def test_f32_convolutions_run_without_tf32_whatever_the_switch(monkeypatch):
    seen = []
    real = F.conv2d

    def spy(*args, **kwargs):
        seen.append((args[0].dtype, torch.backends.cudnn.allow_tf32))
        return real(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    images = torch.rand(2, 64, 64, 3)
    for dtype in (torch.float32, torch.bfloat16):
        model = create_clip(CLIPConfig(**SMALL_RN), dtype=dtype, device="cpu")
        with torch.no_grad():
            model.encode_image(images.to(dtype))
    x = torch.randn(1, 8, 8, 16)
    w = (torch.randn(16, 8), torch.randn(8), torch.randn(3, 3, 8, 8), torch.randn(8),
         torch.randn(8, 16), torch.randn(16))
    conv_gemm.xla_bottleneck(x, *w)
    conv_gemm.xla_bottleneck(x.bfloat16(), *(t.bfloat16() for t in w))
    assert torch.backends.cudnn.allow_tf32  # the switch is restored
    f32 = [flag for dt, flag in seen if dt == torch.float32]
    bf16 = [flag for dt, flag in seen if dt == torch.bfloat16]
    assert f32 and not any(f32)  # the tower's and both plain blocks' f32 convs
    assert bf16 and all(bf16)  # bf16 convolutions are left as they were


@pytest.fixture
def card_at_defaults():
    """A card, with the process-wide TF32 switches at PyTorch's defaults."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_f32_rn50_tower_matches_cpu_on_card(card_at_defaults):
    images = torch.rand(4, 224, 224, 3, generator=torch.Generator().manual_seed(0))
    out = {}
    for device in ("cpu", "cuda"):
        model = create_clip("RN50", dtype=torch.float32, device=device,
                            generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            out[device] = model.encode_image(images.to(device)).cpu().numpy()
    gap = np.abs(out["cuda"] - out["cpu"]).max() / np.abs(out["cpu"]).max()
    print(f"f32 RN50 image tower, card against CPU: {gap:.3e} of scale")  # shown with -s
    # 1e-5, inside PERF.md's 1e-3 for f32 towers: f32 sum order leaves ~1e-6
    # on one H100, while TF32 convolutions leave ~4e-4, which 1e-3 would admit
    _close(out["cuda"], out["cpu"], 1e-5)


def _archive(tmp_path):
    from debiasing_multi_modal_tpu_torch.weights.convert import save_jit_state_dict_archive

    model = create_clip(CLIPConfig(**SMALL_RN), device="cpu",
                        generator=torch.Generator().manual_seed(4))
    path = str(tmp_path / "small_rn.pt")
    save_jit_state_dict_archive({k: v.numpy() for k, v in model.state_dict().items()}, path)
    return path


def test_checkpoint_archive_loads_alike_in_both_packages(tmp_path):
    """The archive reads to the same arrays and the same architecture in
    both packages, and loads strictly into the port's model; the CLI test
    below extracts with it through both packages and compares the outputs."""
    from debiasing_multi_modal_tpu.weights import convert as jconvert
    from debiasing_multi_modal_tpu_torch.weights import convert as tconvert

    path = _archive(tmp_path)
    sd_ref, sd = jconvert.load_openai_checkpoint(path), tconvert.load_openai_checkpoint(path)
    assert set(sd) == set(sd_ref)
    for k in sd:
        np.testing.assert_array_equal(sd[k], sd_ref[k])
    jcfg = jconvert.config_from_state_dict(sd_ref, name="RN50")
    tcfg = tconvert.config_from_state_dict(sd, name="RN50")
    for field in ("embed_dim", "image_resolution", "vision_layers", "vision_width",
                  "vision_patch_size", "context_length", "vocab_size", "transformer_width",
                  "transformer_heads", "transformer_layers"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    model = tconvert.clip_from_state_dict(sd, name="RN50", device="cpu")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])


def test_celeba_layout_through_both_extraction_clis(tmp_path, synthetic_bpe, monkeypatch):
    from debiasing_multi_modal_tpu.cli import extract_main as jextract
    from debiasing_multi_modal_tpu.data import embeddings_store as jstore
    from debiasing_multi_modal_tpu.utils import compilation_cache
    from debiasing_multi_modal_tpu_torch.cli import extract_main as textract
    from test_coverage_gaps5 import _write_celeba_tree

    _write_celeba_tree(tmp_path, n=9, res=64)
    path = _archive(tmp_path)
    monkeypatch.setattr(compilation_cache, "enable_persistent_cache", lambda: None)
    flags = ["--data_dir", str(tmp_path), "--dataset", "celeba", "--split", "all",
             "--backbone", "RN50", "--checkpoint", path, "--batch_size", "4",
             "--host_resolution", "64", "--save", "--num_workers", "0"]
    jextract.main(jextract.build_parser().parse_args(flags + ["--embedding_dir", "emb_jax"]))
    textract.main(textract.build_parser().parse_args(
        flags + ["--embedding_dir", "emb", "--device", "cpu"]))
    root = tmp_path / "emb" / "celeba"
    ref_root = tmp_path / "emb_jax" / "celeba"
    ours = jstore.load_embeddings(str(root / "RN50" / "clip.npz"))
    ref = jstore.load_embeddings(str(ref_root / "RN50" / "clip.npz"))
    assert ours.embeddings.shape == (9, 64)
    _close(ours.embeddings, ref.embeddings, 1e-4)
    for col in ("filenames", "y", "place", "group", "split", "y_pred"):
        np.testing.assert_array_equal(getattr(ours, col), getattr(ref, col))
    rec = next(iter(json.loads((root / "RN50" / "clip.json").read_text()).values()))
    assert "blond" in rec and "male" in rec  # the CelebA key schema
    for kind in ("class", "spurious", "group"):
        _close(jstore.load_text_embeddings(str(root / f"clip_{kind}.json")),
               jstore.load_text_embeddings(str(ref_root / f"clip_{kind}.json")), 1e-4)


def test_tokenizer_searches_the_jax_places_inside_its_checkout_and_home():
    from debiasing_multi_modal_tpu.tokenizer import bpe as jbpe
    from debiasing_multi_modal_tpu_torch.tokenizer import bpe as tbpe

    ours, ref = tbpe._VOCAB_SEARCH_PATHS, jbpe._VOCAB_SEARCH_PATHS
    cache = os.path.join(os.path.expanduser("~/.cache/clip"), "bpe_simple_vocab_16e6.txt.gz")

    def in_repo(path):
        return os.path.commonpath([os.path.abspath(path), REPO]) == REPO

    # each package first searches its own assets directory, then the user's
    # CLIP cache under HOME
    tail = ("tokenizer", "assets", "bpe_simple_vocab_16e6.txt.gz")
    assert tuple(ours[0].split(os.sep)[-3:]) == tuple(ref[0].split(os.sep)[-3:]) == tail
    assert in_repo(ours[0]) and in_repo(ref[0])
    assert ours[1:] == ref[1:2] == (cache,)
    # the JAX package's entries after those lie outside the checkout and
    # are deliberately not mirrored: the port reads nothing around its checkout
    assert ref[2:] and not any(in_repo(p) for p in ref[2:])
