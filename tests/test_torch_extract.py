"""Stage A as a whole: the port's extraction (debiasing_multi_modal_tpu_torch/
extract, cli) against the JAX package's on one set of weights, f32 on the
CPU — embeddings to 1e-4 of their scale, predictions equal — with a small
ResNet and a small ViT (plain and ``fuse_qkv``), plus prompt encoding with
both tokenizers on one synthetic merges file, cache interchange with the JAX
package, crash-safe shard resume, and the CLI end to end at the full width
of RN50 and ViT-B/32 (plain and ``--quantize int8_pallas``).

The real CLIP merges file is not in the repository, so the tokenizers read a
synthetic one: a header line and 48,894 distinct merge rules over pairs of
byte symbols, which gives the full 49,408-id vocabulary.
"""

import dataclasses
import gzip
import os

import jax
import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu.data import embeddings_store as jstore
from debiasing_multi_modal_tpu.extract import runner as jrunner
from debiasing_multi_modal_tpu.models import create_clip as jax_create_clip
from debiasing_multi_modal_tpu.models import init_clip
from debiasing_multi_modal_tpu.models.config import CLIPConfig as JaxConfig
from debiasing_multi_modal_tpu.models.config import get_config as jax_get_config
from debiasing_multi_modal_tpu.parallel.mesh import make_mesh
from debiasing_multi_modal_tpu.tokenizer import bpe as jbpe
from debiasing_multi_modal_tpu_torch.data import embeddings_store as tstore
from debiasing_multi_modal_tpu_torch.extract import runner as trunner
from debiasing_multi_modal_tpu_torch.models import CLIPConfig, create_clip
from debiasing_multi_modal_tpu_torch.templates import WATERBIRDS
from debiasing_multi_modal_tpu_torch.tokenizer import bpe as tbpe
from debiasing_multi_modal_tpu_torch.weights.convert import state_dict_from_jax_variables

SMALL_RN = dict(
    name="small-rn", embed_dim=64, image_resolution=64, vision_layers=(1, 1, 1, 1),
    vision_width=16, vision_patch_size=None, transformer_width=128,
    transformer_heads=2, transformer_layers=2,
)
SMALL_VIT = dict(
    name="small-vit", embed_dim=64, image_resolution=64, vision_layers=2,
    vision_width=128, vision_patch_size=16, transformer_width=128,
    transformer_heads=2, transformer_layers=2,
)
N_MERGES = 49152 - 256 - 2


def _close(ours, ref, rel=1e-4):
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def pair():
    jm = jax_create_clip(JaxConfig(**SMALL_RN))
    variables = jax.device_get(init_clip(jm, jax.random.PRNGKey(0)))
    tm = create_clip(CLIPConfig(**SMALL_RN), device="cpu")
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        state_dict_from_jax_variables(variables).items()}, strict=True)
    return jm, variables, tm


@pytest.fixture(scope="module")
def vit_pair():
    jcfg = dataclasses.replace(jax_get_config("ViT-B/32"), **SMALL_VIT)
    variables = jax.device_get(init_clip(jax_create_clip(jcfg), jax.random.PRNGKey(1)))
    sd = {k: torch.from_numpy(v) for k, v in state_dict_from_jax_variables(variables).items()}
    models = {}
    for fuse_qkv in (False, True):
        tm = create_clip(CLIPConfig(**SMALL_VIT), device="cpu", fuse_qkv=fuse_qkv)
        tm.load_state_dict(sd, strict=True)
        models[fuse_qkv] = (jax_create_clip(jcfg, fuse_qkv=fuse_qkv), tm)
    return variables, models


def _write_merges(path):
    syms = tbpe._vocab_symbol_order()
    merges = []
    for a in syms:
        for b in syms:
            merges += [f"{a} {b}", f"{a} {b}</w>"]
            if len(merges) >= N_MERGES:
                break
        if len(merges) >= N_MERGES:
            break
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: synthetic"] + merges[:N_MERGES]) + "\n")


@pytest.fixture
def synthetic_bpe(tmp_path, monkeypatch):
    path = str(tmp_path / "bpe_simple_vocab_16e6.txt.gz")
    _write_merges(path)
    monkeypatch.setenv("CLIP_BPE_PATH", path)
    jbpe.default_tokenizer.cache_clear()
    tbpe.default_tokenizer.cache_clear()
    yield path
    jbpe.default_tokenizer.cache_clear()
    tbpe.default_tokenizer.cache_clear()


def _batches(n_batches, bs, size=(72, 96), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        y = rng.integers(0, 2, bs).astype(np.int32)
        place = rng.integers(0, 2, bs).astype(np.int32)
        out.append((
            rng.integers(0, 256, (bs, *size, 3), dtype=np.uint8),
            {"filenames": np.asarray([f"b{b}_{i}.jpg" for i in range(bs)]),
             "y": y, "place": place, "group": y * 2 + place,
             "split": np.zeros(bs, np.int32)},
        ))
    return out


def test_tokenizers_agree(synthetic_bpe):
    texts = WATERBIRDS.prompts("group") + ["A PHOTO of   <|endoftext|> x-ray 42!"]
    ours, ref = tbpe.tokenize(texts), jbpe.tokenize(texts)
    assert ours.shape == (len(texts), 77) and ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    assert tbpe.default_tokenizer().decode(ours[0][1:5]) == \
        jbpe.default_tokenizer().decode(ref[0][1:5])


def test_encode_text_prompts_matches_jax(synthetic_bpe, pair):
    jm, variables, tm = pair
    sets = {k: WATERBIRDS.prompts(k) for k in ("class", "spurious", "group")}
    ref = jrunner.encode_text_prompts(jm, variables, sets)
    ours = trunner.encode_text_prompts(tm, sets)
    for kind in sets:
        assert ours[kind].dtype == np.float32
        _close(ours[kind], ref[kind])
    pooled = trunner.encode_text_prompts(tm, {"g": sets["group"]}, templates_per_phrase=2)
    np.testing.assert_allclose(
        pooled["g"], ours["group"].reshape(2, 2, -1).mean(axis=1), atol=1e-6)


@pytest.mark.parametrize("normalized", [False, True])
def test_run_matches_jax(pair, normalized):
    jm, variables, tm = pair
    text = np.random.default_rng(1).standard_normal((2, 64)).astype(np.float32)
    batches = _batches(3, 4)
    ref = jrunner.ExtractionRunner(jm, variables, text, mesh=make_mesh((1,)),
                                   normalized=normalized).run(iter(batches))
    ours = trunner.ExtractionRunner(tm, text, normalized=normalized).run(iter(batches))
    _close(ours.embeddings, ref.embeddings)
    np.testing.assert_array_equal(ours.y_pred, ref.y_pred)
    for col in ("filenames", "y", "place", "group", "split"):
        np.testing.assert_array_equal(getattr(ours, col), getattr(ref, col))


@pytest.mark.parametrize("fuse_qkv", [False, True])
def test_vit_run_matches_jax(vit_pair, fuse_qkv):
    variables, models = vit_pair
    jm, tm = models[fuse_qkv]
    text = np.random.default_rng(6).standard_normal((2, 64)).astype(np.float32)
    batches = _batches(3, 4, seed=2)
    ref = jrunner.ExtractionRunner(jm, variables, text, mesh=make_mesh((1,))).run(iter(batches))
    ours = trunner.ExtractionRunner(tm, text).run(iter(batches))
    assert ours.embeddings.shape == (12, 64)
    _close(ours.embeddings, ref.embeddings)
    np.testing.assert_array_equal(ours.y_pred, ref.y_pred)
    np.testing.assert_array_equal(ours.filenames, ref.filenames)


def test_encode_batch_and_preprocessed_path(pair):
    _, _, tm = pair
    text = np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32)
    runner = trunner.ExtractionRunner(tm, text)
    imgs = _batches(1, 5)[0][0]
    emb, preds = runner.encode_batch(imgs)
    assert emb.shape == (5, 64) and emb.dtype == np.float32
    assert preds.dtype == np.int32 and set(preds) <= {0, 1, 2}
    pre = trunner.ExtractionRunner(tm, text, preprocessed=True)
    emb64, _ = pre.encode_batch(_batches(1, 2, size=(64, 64))[0][0])
    assert emb64.shape == (2, 64) and np.isfinite(emb64).all()


def test_cache_loads_in_jax_package(tmp_path, pair):
    _, _, tm = pair
    text = np.random.default_rng(3).standard_normal((2, 64)).astype(np.float32)
    table = trunner.ExtractionRunner(tm, text).run(iter(_batches(2, 3)))
    for name in ("clip.json", "clip.npz"):
        path = str(tmp_path / name)
        tstore.save_embeddings(path, table, fmt=name.rsplit(".", 1)[1], dataset="waterbirds")
        loaded = jstore.load_embeddings(path, dataset="waterbirds")
        np.testing.assert_allclose(loaded.embeddings, table.embeddings, atol=1e-6)
        np.testing.assert_array_equal(loaded.y_pred, table.y_pred)
        np.testing.assert_array_equal(loaded.filenames, table.filenames)
        back = tstore.load_embeddings(path, dataset="waterbirds")
        np.testing.assert_array_equal(back.group, table.group)
    tpath = str(tmp_path / "clip_class.json")
    tstore.save_text_embeddings(tpath, WATERBIRDS.prompts("class"), text)
    np.testing.assert_allclose(jstore.load_text_embeddings(tpath), text.T, atol=1e-6)
    report = trunner.minority_report(table.y, table.place, table.y_pred, "waterbirds")
    assert isinstance(report, str) and report


def test_shard_resume_produces_same_table(tmp_path, pair):
    _, _, tm = pair
    text = np.random.default_rng(4).standard_normal((2, 64)).astype(np.float32)
    runner = trunner.ExtractionRunner(tm, text)
    batches = _batches(5, 3, seed=5)
    full = runner.run(iter(batches), prefetch_depth=0)

    def crashing():
        yield from batches[:3]
        raise RuntimeError("killed")

    shard_dir = str(tmp_path / "shards")
    meta = {"backbone": "small-rn"}
    with pytest.raises(RuntimeError, match="killed"):
        runner.run(crashing(), shard_dir=shard_dir, shard_every=2, shard_meta=meta)
    assert trunner.completed_rows(shard_dir) == 6
    resumed = runner.run(iter(batches), shard_dir=shard_dir, shard_every=2,
                         shard_meta=meta)
    np.testing.assert_array_equal(resumed.filenames, full.filenames)
    np.testing.assert_allclose(resumed.embeddings, full.embeddings, atol=1e-6)
    np.testing.assert_array_equal(resumed.y_pred, full.y_pred)
    with pytest.raises(ValueError, match="different"):
        runner.run(iter(batches), shard_dir=shard_dir, shard_every=2,
                   shard_meta={"backbone": "other"})
    with pytest.raises(ValueError, match="misalignment"):
        runner.run(iter(_batches(5, 4, seed=5)), shard_dir=shard_dir, shard_every=2,
                   shard_meta=meta)


def _waterbirds_tree(tmp_path):
    """Six 96x72 JPEGs and their metadata in the Waterbirds layout."""
    from PIL import Image

    root = tmp_path / "data" / "waterbirds" / "waterbird_complete95_forest2water2"
    (root / "imgs").mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = ["img_id,img_filename,y,split,place"]
    for k in range(6):
        fn = f"imgs/{k:05d}.jpg"
        Image.fromarray(rng.integers(0, 256, (96, 72, 3), dtype=np.uint8)).save(root / fn)
        rows.append(f"{k},{fn},{k % 2},{k // 2},{(k // 2) % 2}")
    (root / "metadata.csv").write_text("\n".join(rows) + "\n")
    return tmp_path / "data"


def _run_cli(data, *flags):
    from debiasing_multi_modal_tpu_torch.cli import extract_main

    extract_main.main(extract_main.build_parser().parse_args([
        "--data_dir", str(data), "--dataset", "waterbirds",
        "--embedding_dir", "emb", "--save", "--batch_size", "4",
        "--device", "cpu", "--num_workers", "0", *flags,
    ]))
    return data / "emb" / "waterbirds"


def _check_caches(out, backbone_dir, dim):
    table = jstore.load_embeddings(str(out / backbone_dir / "clip.npz"))
    assert table.embeddings.shape == (6, dim) and np.isfinite(table.embeddings).all()
    js = jstore.load_embeddings(str(out / backbone_dir / "clip.json"), dataset="waterbirds")
    np.testing.assert_allclose(js.embeddings, table.embeddings, atol=1e-6)
    np.testing.assert_array_equal(js.y_pred, table.y_pred)
    assert jstore.load_text_embeddings(str(out / "clip_group.json")).shape == (dim, 4)
    return table


def test_cli_extracts_waterbirds_on_cpu(tmp_path, synthetic_bpe):
    """The port's CLI end to end on the CPU (full-width RN50, random
    weights), unfused and with ``--fuse_bn``: the caches it writes load in
    the JAX package, and with identity BatchNorms folding changes nothing
    beyond f32 rounding.  ``--fuse_bn`` on a ViT exits, as the JAX CLI
    does; ``--quantize`` on a ResNet raises ``ValueError``, as the JAX CLI
    refuses it; ``--tensor_parallel 2`` is not ported yet."""
    from debiasing_multi_modal_tpu_torch.cli import extract_main

    data = _waterbirds_tree(tmp_path)
    out = _run_cli(data)
    plain = _check_caches(out, "RN50", 1024)
    _run_cli(data, "--fuse_bn", "--embedding_dir", "emb_fused")
    folded = _check_caches(data / "emb_fused" / "waterbirds", "RN50", 1024)
    _close(folded.embeddings, plain.embeddings)
    np.testing.assert_array_equal(folded.y_pred, plain.y_pred)
    with pytest.raises(SystemExit, match="ResNet backbones only"):
        extract_main.main(extract_main.build_parser().parse_args(
            ["--device", "cpu", "--backbone", "ViT-B/32", "--fuse_bn"]))
    with pytest.raises(ValueError, match="ViT-only"):
        extract_main.main(extract_main.build_parser().parse_args(
            ["--device", "cpu", "--quantize", "int8"]))
    with pytest.raises(NotImplementedError):
        extract_main.main(extract_main.build_parser().parse_args(
            ["--device", "cpu", "--tensor_parallel", "2"]))
    assert os.path.isdir(out)


@pytest.mark.parametrize("quantize", ["none", "int8_pallas"])
def test_cli_extracts_waterbirds_vit_on_cpu(tmp_path, synthetic_bpe, quantize):
    """The CLI at the full width of ViT-B/32 (random weights), plain and
    with the int8 GEMM path: the caches load in the JAX package."""
    out = _run_cli(_waterbirds_tree(tmp_path), "--backbone", "ViT-B/32",
                   "--quantize", quantize)
    table = _check_caches(out, "ViT-B-32", 512)
    assert set(table.y_pred) <= {0, 1}
