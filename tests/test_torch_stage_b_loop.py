"""Stage B as a whole in the port (debiasing_multi_modal_tpu_torch/train/
loop.py ``train_all_epochs``, train/checkpoint.py, cli/train_main.py)
against the JAX package's, f32 on the CPU.

Both packages start from one initial state: the JAX package's ``capture``
records its initial weights in the reference's state-dict layout, and the
port takes them as ``init``; for ``linear_probing`` and ``resample_ce``,
which ``capture`` refuses, the test rebuilds the JAX draws
(``jax.random.split`` through ``make_classifier`` and ``_init_variables``, as
the JAX loop does).  One ``random_seed`` gives both the same numpy batch
plans, so the per-epoch ``ordered`` result dicts, the best epoch and the
zero-shot dicts are equal, on ``make_synthetic_dataset(SyntheticSpec())``
(64-dim, 512/256/256 rows), 4 epochs across the phase boundary.

Within the port: a run resumed from a checkpoint at the phase boundary (and
one inside phase 2) equals the uninterrupted run bit for bit, history and
final state; the results JSON has the JAX package's schema; the CLI trains
on caches the port's own extraction CLI wrote and prints the JAX CLI's
result lines on them.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu.data.synthetic import SyntheticSpec as JaxSpec
from debiasing_multi_modal_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from debiasing_multi_modal_tpu.train import loop as jloop
from debiasing_multi_modal_tpu.train.config import TrainConfig as JaxConfig
from debiasing_multi_modal_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_dataset
from debiasing_multi_modal_tpu_torch.train import checkpoint as tckpt
from debiasing_multi_modal_tpu_torch.train import loop as tloop
from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
from debiasing_multi_modal_tpu_torch.weights.convert import (
    classifier_state_dict_from_jax_variables,
)
from test_torch_extract import synthetic_bpe  # noqa: F401  (a fixture)

BASE = dict(dataset="waterbirds", input_dim=64, adapter_feat_dim=16, batch_size=128,
            batch_size_reg=32, learning_rate=0.5, learning_rate_reg=0.5,
            lr_decay_epochs=(100,), random_seed=42, epochs=4)


def _splits(meta):
    return {name: meta.take(np.where(meta.split == sid)[0])
            for name, sid in (("train", 0), ("val", 1), ("test", 2))}


@pytest.fixture(scope="module")
def bundles():
    meta, table, tc, tg, ts = jax_synthetic(JaxSpec())
    jb = jloop.bundle_from_embedding_table(table, _splits(meta), tc, ts, tg)
    meta, table, tc, tg, ts = make_synthetic_dataset(SyntheticSpec())
    tb = tloop.bundle_from_embedding_table(table, _splits(meta), tc, ts, tg, device="cpu")
    return jb, tb


def _jax_init(cfg):
    """The JAX loop's initial draws, rebuilt (loop.py:376-377, :592-595)."""
    key = jax.random.PRNGKey(cfg.random_seed)
    key, init_key = jax.random.split(key)
    params, stats = jloop._init_variables(jloop.make_classifier(cfg), cfg.input_dim,
                                          init_key, cfg.n_cls)
    init = {"init_sd": classifier_state_dict_from_jax_variables(
        {"params": params, "batch_stats": stats})}
    if cfg.add_adapter:
        key_new, key = jax.random.split(key)
        params, stats = jloop._init_variables(jloop.make_multiple_classifier(cfg),
                                              cfg.input_dim, key_new, cfg.n_cls)
        init["ma_new_sd"] = classifier_state_dict_from_jax_variables(
            {"params": params, "batch_stats": stats})
    return init


RUNS = {
    "linear_probing_resample_ce": dict(tl_method="linear_probing", resample_ce=True),
    "adapter": dict(tl_method="adapter"),
    "adapter_reg_balance_val": dict(tl_method="adapter_reg", balance_val=True),
    "adapter_reg_seq_continue_from_best": dict(
        tl_method="adapter_reg_seq", epochs_feature_learning=2, continue_from_best=True),
    "adapter_reg_seq_alter_add_adapter_resample_ce": dict(
        tl_method="adapter_reg_seq_alter", epochs_feature_learning=2, add_adapter=True,
        resample_ce=True),
    "adapter_reg_seq_alter_add_adapter_balance_val": dict(
        tl_method="adapter_reg_seq_alter", epochs_feature_learning=2, add_adapter=True,
        balance_val=True, continue_from_best=True, warm_reg=True),
    # CelebA's dataset-conditional reg warmup (2 epochs, not 10)
    "adapter_reg_seq_celeba_warm_reg": dict(
        tl_method="adapter_reg_seq", epochs_feature_learning=2, dataset="celeba",
        warm_reg=True),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_train_all_epochs_matches_jax(bundles, run):
    jb, tb = bundles
    flags = {**BASE, **RUNS[run]}
    jcfg = JaxConfig(**flags)
    if jcfg.tl_method == "linear_probing" or jcfg.resample_ce:
        capture, init = None, _jax_init(jcfg)
    else:
        capture = {}
    ref = jloop.train_all_epochs(jcfg, jb, verbose=False, capture=capture)
    if capture is not None:
        init = capture
    ours = tloop.train_all_epochs(TrainConfig(**flags), tb, verbose=False, init=init,
                                  device="cpu")
    (best_ref, zs_ref, hist_ref), (best, zs, hist) = ref, ours
    for split in ("train", "val", "test"):
        assert hist[split] == hist_ref[split], split
    assert best == best_ref and zs == zs_ref


RESUMES = {
    "at_the_phase_boundary": 2,
    "inside_phase_2": 3,
}


@pytest.mark.parametrize("where", sorted(RESUMES))
def test_resume_equals_the_uninterrupted_run(tmp_path, bundles, where):
    """An interrupted run, resumed from its checkpoint, gives the
    uninterrupted run's history, best model and final state bit for bit; at
    the phase boundary the resumed run draws the new adapter from the
    restored generator."""
    _, tb = bundles
    cfg = TrainConfig(**{**BASE, **RUNS["adapter_reg_seq_alter_add_adapter_balance_val"]})
    full_dir, part_dir = str(tmp_path / "full"), str(tmp_path / "part")
    full = tloop.train_all_epochs(cfg, tb, verbose=False, checkpoint_dir=full_dir,
                                  checkpoint_every=100, device="cpu")
    tloop.train_all_epochs(cfg.replace(epochs=RESUMES[where]), tb, verbose=False,
                           checkpoint_dir=part_dir, checkpoint_every=1, device="cpu")
    resumed = tloop.train_all_epochs(cfg, tb, verbose=False, checkpoint_dir=part_dir,
                                     resume=True, checkpoint_every=100, device="cpu")
    assert resumed == full
    _, a, meta_a = tckpt.load_checkpoint(tckpt.latest_checkpoint(full_dir))
    _, b, meta_b = tckpt.load_checkpoint(tckpt.latest_checkpoint(part_dir))
    assert meta_a["history"] == meta_b["history"] and meta_a["rng_state"] == meta_b["rng_state"]
    assert set(a) == set(b) == {"state", "ma_state", "best_state", "torch_rng_state"}

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix, tree

    la, lb = dict(leaves(a)), dict(leaves(b))
    assert set(la) == set(lb)
    for k in la:
        assert torch.equal(la[k], lb[k]), k


def test_save_results_schema_and_guards(tmp_path, bundles):
    """The results JSON has the JAX package's schema
    (test_train_e2e.py::test_save_results_schema) and names; the best model
    is saved in the reference's layout.  A label past the text matrix's
    columns raises, and the contrastive adapter is not ported yet."""
    _, tb = bundles
    cfg = TrainConfig(tl_method="adapter_reg_seq_alter", epochs_feature_learning=2,
                      add_adapter=True, save_results=True, **BASE)
    tloop.train_all_epochs(cfg, tb, verbose=False, results_dir=str(tmp_path), device="cpu")
    name = tloop.encode_run_name(cfg)
    assert name == jloop.encode_run_name(JaxConfig(**{**BASE, **dict(
        tl_method="adapter_reg_seq_alter", epochs_feature_learning=2, add_adapter=True,
        save_results=True)})) and name.endswith("_MA+rn")
    payload = json.loads((tmp_path / (name + ".json")).read_text())
    assert set(payload) == {"Final Results (best epoch)", "Feature Quality (using zs)",
                            "All Results (all epoch)"}
    epochs = payload["All Results (all epoch)"]
    assert len(epochs) == 4
    rec = epochs["Epoch 1"]["Test"]
    assert "worst_acc" in rec and "weighted_mean_acc" in rec
    best = torch.load(tmp_path / (name + ".pt"), weights_only=True)
    assert best and all(k.startswith(("adapter.layers.", "old_cls.adapter.layers.",
                                      "new_adapter.layers.")) for k in best)
    with pytest.raises(ValueError, match="columns"):
        tloop.train_all_epochs(TrainConfig(tl_method="adapter", train_target="group",
                                           **{**BASE, "epochs": 1}), tb, verbose=False,
                               device="cpu")
    with pytest.raises(NotImplementedError, match="contrastive"):
        tloop.train_all_epochs(TrainConfig(tl_method="contrastive_adapter", **BASE), tb,
                               verbose=False, device="cpu")


def _waterbirds_tree(root):
    """24 small JPEGs in the Waterbirds layout, each split holding every
    group twice (the stratified reg/val split needs two per group)."""
    from PIL import Image

    img_root = root / "waterbirds" / "waterbird_complete95_forest2water2"
    (img_root / "imgs").mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = ["img_id,img_filename,y,split,place"]
    for k in range(24):
        fn = f"imgs/{k:05d}.jpg"
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(img_root / fn)
        g = k % 4
        rows.append(f"{k},{fn},{g // 2},{k // 8},{g % 2}")
    (img_root / "metadata.csv").write_text("\n".join(rows) + "\n")
    return img_root


TINY_RN = dict(name="tiny-rn", embed_dim=32, image_resolution=64, vision_layers=(1, 1, 1, 1),
               vision_width=8, vision_patch_size=None, transformer_width=64,
               transformer_heads=1, transformer_layers=1)

RESULT_PREFIXES = ("> Start", "--- Epoch", "Train:", "Val:", "Test:", "Stage 2)",
                   "best epoch", "zero-shot", "best train:", "best val:", "best test:")


def test_train_cli_on_caches_the_port_extracted(tmp_path, monkeypatch, capsys, synthetic_bpe):
    from debiasing_multi_modal_tpu.cli import train_main as jtrain
    from debiasing_multi_modal_tpu.utils import compilation_cache
    from debiasing_multi_modal_tpu_torch import models as tmodels
    from debiasing_multi_modal_tpu_torch.cli import extract_main as textract
    from debiasing_multi_modal_tpu_torch.cli import train_main as ttrain
    from debiasing_multi_modal_tpu_torch.models import CLIPConfig

    real_create = tmodels.create_clip
    monkeypatch.setattr(tmodels, "create_clip",
                        lambda name, **kw: real_create(CLIPConfig(**TINY_RN), **kw))
    img_root = _waterbirds_tree(tmp_path)
    textract.main(textract.build_parser().parse_args([
        "--data_dir", str(tmp_path), "--dataset", "waterbirds", "--embedding_dir", "emb",
        "--save", "--batch_size", "8", "--host_resolution", "64", "--device", "cpu",
        "--num_workers", "0", "--format", "npz"]))
    emb = tmp_path / "emb" / "waterbirds"
    flags = ["--dataset", "waterbirds", "--data_dir", str(img_root),
             "--image_embedding_dir", str(emb / "RN50" / "clip.npz"),
             "--text_embedding_dir", str(emb / "clip_class.json"),
             "--text_spurious_embedding_dir", str(emb / "clip_spurious.json"),
             "--text_group_embedding_dir", str(emb / "clip_group.json"),
             "--tl_method", "adapter_reg_seq_alter", "--add_adapter", "--warm_reg",
             "--epochs", "4", "--epochs_feature_learning", "2", "--batch_size", "8",
             "--batch_size_reg", "4", "--learning_rate", "1.0", "--learning_rate_reg", "1.0",
             "--lr_decay_rate", "0.1", "--lr_decay_epochs", "90,95", "--adapter_feat_dim",
             "16", "--save_results"]
    capture = {}
    jax_run = jloop.train_all_epochs
    monkeypatch.setattr(jloop, "train_all_epochs",
                        lambda *a, **kw: jax_run(*a, capture=capture, **kw))
    monkeypatch.setattr(compilation_cache, "enable_persistent_cache", lambda: None)
    capsys.readouterr()
    jtrain.main(jtrain.build_parser().parse_args(
        flags + ["--results_dir", str(tmp_path / "jax_results")]))
    ref = capsys.readouterr().out
    port_run = tloop.train_all_epochs
    monkeypatch.setattr(tloop, "train_all_epochs",
                        lambda *a, **kw: port_run(*a, init=capture, **kw))
    assert ttrain.main(ttrain.build_parser().parse_args(
        flags + ["--results_dir", str(tmp_path / "results"), "--device", "cpu"])) == 0
    ours = capsys.readouterr().out

    def result_lines(out):
        return [line for line in out.splitlines() if line.startswith(RESULT_PREFIXES)]

    assert len(result_lines(ours)) == 4 * 4 + 1 + 1 + 1 + 2 + 3
    assert result_lines(ours) == result_lines(ref)
    names = sorted(os.listdir(tmp_path / "results"))
    assert [n.rsplit(".", 1)[1] for n in names] == ["json", "pt"]
    assert names[0] in os.listdir(tmp_path / "jax_results")
