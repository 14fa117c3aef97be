"""The stacked sweep in the port (debiasing_multi_modal_tpu_torch/sweep/
vmap_loop.py ``train_seeds_vmapped``, sweep/runner.py, cli/sweep_main.py)
against the JAX package's, f32 on the CPU.

- Against JAX: the cases of the JAX suite's vmapped-against-sequential test,
  on its bundle (256/128/128 rows), 5 epochs, seeds [42, 32].  Both packages
  start every row from the JAX sweep's own initial draws (rebuilt through its
  ``_init_stacked`` / ``_init_head_stacked``, in both split orders, and passed
  to the port as ``inits``), and one seed gives both the same numpy plans,
  so every per-row result dict is equal.
- Within the port: each stacked row equals the port's own sequential
  ``train_all_epochs`` of that row within the JAX suite's 2e-3 (lr-stacked,
  bsr-stacked with differing reg batch sizes, the full lr x bsr x bs grid,
  bs-stacked on a method without a reg phase), and the stacked epoch's
  padded steps leave a row's state exactly as it was.
- The CSVs: ``aggregate_csv`` writes the JAX function's bytes, and
  ``run_sweep`` on a two-cell grid writes the JAX ``run_sweep``'s file names
  and bytes; ``skip_existing`` stacks only the missing cells; seeds past
  2**32 run; a one-process ``mesh`` changes nothing.
- The CLI on caches the port's own extraction CLI wrote writes the JAX
  ``sweep_main``'s file names and the port library's bytes, and rejects
  ``--no_vmap`` with ``--stack_*``; ``--seed_mesh`` in one process
  writes the same bytes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu.data.synthetic import SyntheticSpec as JaxSpec
from debiasing_multi_modal_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from debiasing_multi_modal_tpu.models.adapter import CAEncoder as JaxCAEncoder
from debiasing_multi_modal_tpu.sweep import runner as jrunner
from debiasing_multi_modal_tpu.sweep import vmap_loop as jvm
from debiasing_multi_modal_tpu.train import loop as jloop
from debiasing_multi_modal_tpu.train.config import TrainConfig as JaxConfig
from debiasing_multi_modal_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_dataset
from debiasing_multi_modal_tpu_torch.sweep import runner as trunner
from debiasing_multi_modal_tpu_torch.sweep import vmap_loop as tvm
from debiasing_multi_modal_tpu_torch.train import loop as tloop
from debiasing_multi_modal_tpu_torch.train import steps as tsteps
from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
from debiasing_multi_modal_tpu_torch.weights.convert import (
    ca_head_state_dict_from_jax,
    classifier_state_dict_from_jax_variables,
)
from test_torch_extract import synthetic_bpe  # noqa: F401  (a fixture)

BASE = dict(dataset="waterbirds", input_dim=64, adapter_feat_dim=16, batch_size=128,
            batch_size_reg=32, learning_rate=0.5, learning_rate_reg=0.5,
            lr_decay_epochs=(100,))
SPEC = dict(n_train=256, n_val=128, n_test=128)
SEEDS = [42, 32]


def _splits(meta):
    return {n: meta.take(np.where(meta.split == s)[0])
            for n, s in (("train", 0), ("val", 1), ("test", 2))}


@pytest.fixture(scope="module")
def bundles():
    meta, table, tc, tg, ts = jax_synthetic(JaxSpec(**SPEC))
    jb = jloop.bundle_from_embedding_table(table, _splits(meta), tc, ts, tg)
    meta, table, tc, tg, ts = make_synthetic_dataset(SyntheticSpec(**SPEC))
    tb = tloop.bundle_from_embedding_table(table, _splits(meta), tc, ts, tg, device="cpu")
    return jb, tb


def jax_row_inits(cfg, seeds):
    """The JAX sweep's initial draws for each row, rebuilt as its
    ``train_seeds_vmapped`` makes them (vmap_loop.py:267-330, :474-477):
    the classifier from each key's second half, the contrastive head from the
    next split's second half, the MultipleAdapter from the first half."""
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    keys, params, stats = jvm._init_stacked(jloop.make_classifier(cfg), cfg, keys, cfg.n_cls)

    def row(tree, i):
        return jax.tree.map(lambda a: np.asarray(a[i]), tree)

    inits = [{"init_sd": classifier_state_dict_from_jax_variables(
        {"params": row(params, i), "batch_stats": row(stats, i)})} for i in range(len(seeds))]
    if cfg.tl_method == "contrastive_adapter" and cfg.ca_head is not None:
        enc = JaxCAEncoder(hidden_dim=cfg.adapter_feat_dim, ca_head=cfg.ca_head,
                           ca_feat_dim=cfg.ca_feat_dim)
        keys, heads = jvm._init_head_stacked(enc, keys, cfg.input_dim)
        for i, init in enumerate(inits):
            init["ca_head_sd"] = ca_head_state_dict_from_jax(row(heads, i))
    if cfg.add_adapter:
        keys, params, stats = jvm._init_stacked(jloop.make_multiple_classifier(cfg), cfg, keys,
                                                cfg.n_cls, init_on_first=True)
        for i, init in enumerate(inits):
            init["ma_new_sd"] = classifier_state_dict_from_jax_variables(
                {"params": row(params, i), "batch_stats": row(stats, i)})
    return inits


def _assert_results_close(a_results, b_results, tol):
    assert len(a_results) == len(b_results)
    for (a_res, a_zs), (b_res, b_zs) in zip(a_results, b_results):
        for a_d, b_d in zip(tuple(a_res) + tuple(a_zs), tuple(b_res) + tuple(b_zs)):
            assert a_d.keys() == b_d.keys()
            for k in a_d:
                assert abs(a_d[k] - b_d[k]) < tol, (k, a_d, b_d)


CA = dict(num_positive=8, num_negative=8, batch_factor=2)
CASES = {
    "adapter": ("adapter", {}),
    "seq_alter_ma": ("adapter_reg_seq_alter", dict(
        epochs_feature_learning=2, balance_val=True, add_adapter=True, init_near_identity=True)),
    "seq_alter_ma_randominit": ("adapter_reg_seq_alter", dict(
        epochs_feature_learning=2, add_adapter=True, init_near_identity=False)),
    "adapter_reg": ("adapter_reg", {}),
    "adapter_reg_cp": ("adapter_reg", dict(use_cls_prompt_in_reg=True)),
    "seq": ("adapter_reg_seq", dict(epochs_feature_learning=2)),
    "resample_ce": ("adapter", dict(resample_ce=True)),
    "linear_probing": ("linear_probing", {}),
    "contrastive": ("contrastive_adapter", CA),
    "contrastive_ce_capped": ("contrastive_adapter", dict(CA, ca_ce_update=1)),
    "contrastive_pure_supcon": ("contrastive_adapter", dict(CA, ca_ce_update=0)),
    "contrastive_linear_head": ("contrastive_adapter", dict(CA, ca_head="linear")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stacked_rows_match_jax(bundles, case):
    jb, tb = bundles
    method, extra = CASES[case]
    flags = dict(tl_method=method, epochs=5, **extra, **BASE)
    jcfg = JaxConfig(**flags)
    ref = jvm.train_seeds_vmapped(jcfg, jb, SEEDS)
    ours = tvm.train_seeds_vmapped(TrainConfig(**flags), tb, SEEDS,
                                   inits=jax_row_inits(jcfg, SEEDS), device="cpu")
    assert ours == ref


# ----------------------------------------------- stacked against sequential --


def _sequential(cfg, bundle, cells, seeds):
    return {trunner.cell_filename(c): [
        tloop.train_all_epochs(c.replace(random_seed=s), bundle, verbose=False,
                               device="cpu")[:2] for s in seeds] for c in cells}


GRID_CFG = dict(tl_method="adapter_reg_seq_alter", epochs=4, epochs_feature_learning=2,
                balance_val=True, add_adapter=True, warm_reg=True, **BASE)
GRIDS = {
    "lr": (GRID_CFG, dict(lr_list=[0.5, 2.0], lr_multiple=2.0), dict(stack_lr_axis=True)),
    "lr_bsr": (GRID_CFG, dict(lr_list=[0.5, 2.0], bsr_list=[8, 32], lr_multiple=2.0),
               dict(stack_lr_axis=True, stack_bsr_axis=True)),
    "lr_bsr_bs": (GRID_CFG, dict(lr_list=[0.5, 2.0], bs_list=[16, 48], bsr_list=[8, 32],
                                 lr_multiple=2.0),
                  dict(stack_lr_axis=True, stack_bsr_axis=True, stack_bs_axis=True)),
    "bs_no_reg_phase": (dict(tl_method="adapter", epochs=3, **BASE),
                        dict(lr_list=[0.5, 2.0], bs_list=[16, 48]),
                        dict(stack_lr_axis=True, stack_bs_axis=True)),
}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_stacked_grid_matches_sequential_runs(bundles, tmp_path, grid):
    _, tb = bundles
    flags, axes, stack = GRIDS[grid]
    cfg = TrainConfig(**flags)
    stacked = trunner.run_sweep(cfg, tb, SEEDS, **axes, **stack,
                                result_root=str(tmp_path), device="cpu")
    n_cells = np.prod([len(v) for k, v in axes.items() if k.endswith("_list")])
    assert len(stacked) == n_cells
    cells = []
    for bs in axes.get("bs_list", [None]):
        for bsr in axes.get("bsr_list", [None]):
            for lr in axes["lr_list"]:
                c = cfg.replace(learning_rate=lr)
                if "lr_multiple" in axes:
                    c = c.replace(learning_rate_reg=lr * axes["lr_multiple"])
                if bs is not None:
                    c = c.replace(batch_size=bs)
                if bsr is not None:
                    c = c.replace(batch_size_reg=bsr)
                cells.append(c)
    seq = _sequential(cfg, tb, cells, SEEDS)
    assert {os.path.basename(p) for p in stacked} == set(seq)
    for path, results in stacked.items():
        _assert_results_close(results, seq[os.path.basename(path)], tol=2e-3)


def test_lr_grid_rows_match_sequential_runs(bundles):
    """``lr_grid`` stacks (lr, lr_reg) cells as rows, cells outer: each row
    is its cell's sequential run within the JAX suite's 2e-3."""
    _, tb = bundles
    cfg = TrainConfig(**GRID_CFG)
    grid = [(0.5, 1.0), (2.0, 4.0)]
    rows = tvm.train_seeds_vmapped(cfg, tb, SEEDS, lr_grid=grid, device="cpu")
    cells = [cfg.replace(learning_rate=lr, learning_rate_reg=lrr) for lr, lrr in grid]
    seq = _sequential(cfg, tb, cells, SEEDS)
    _assert_results_close(rows, [r for c in cells for r in seq[trunner.cell_filename(c)]],
                          tol=2e-3)
    with pytest.raises(ValueError, match="either lr_grid or cell_grid"):
        tvm.train_seeds_vmapped(cfg, tb, SEEDS, lr_grid=grid, cell_grid=cells, device="cpu")


def test_padded_steps_are_no_ops():
    """Rows whose epochs differ in length pad to the longest under
    ``active=False``: after the stacked epoch each row's parameters, momentum,
    BatchNorm statistics and meters equal, bit for bit, those of the same row
    run alone over its own steps only.  A zero learning rate on the padded
    steps instead still moves the momentum and the statistics."""
    from debiasing_multi_modal_tpu_torch.data.samplers import epoch_plan
    from debiasing_multi_modal_tpu_torch.models.adapter import AdapterClassifier

    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 2, 50))
    groups = torch.from_numpy(rng.integers(0, 4, 50))
    text = torch.from_numpy(rng.standard_normal((8, 2)).astype(np.float32))
    plans = [epoch_plan(50, 16, True, np.random.default_rng(1)),
             epoch_plan(50, 7, True, np.random.default_rng(2))]
    idx, msk, act = (torch.from_numpy(a) for a in tvm._pad_stack_plans(plans))
    assert not act.all()
    lrs = torch.full(act.shape, 0.3)

    def fresh():
        modules = [AdapterClassifier(8, 4, generator=torch.Generator().manual_seed(k))
                   for k in range(2)]
        state = tsteps.StackedState.stack(modules, "cpu")
        for k in state.trace:  # a nonzero momentum: decay would show
            state.trace[k].normal_(generator=torch.Generator().manual_seed(3))
        return state

    def run(state, rows, steps, lrs_, active):
        return tsteps.train_epoch_vmapped(
            state, emb, labels, groups, idx[rows, :steps], msk[rows, :steps], lrs_, text,
            tsteps.ones_mask(state.params), active=active)[1]

    both = fresh()
    stats = run(both, slice(None), None, lrs, act)
    for i, p in enumerate(plans):
        nb = p.num_batches
        alone = fresh()
        alone_stats = run(alone, slice(None), nb, lrs[:, :nb], act[:, :nb])
        for tree, ref in ((both.params, alone.params), (both.buffers, alone.buffers),
                          (both.trace, alone.trace)):
            for k in ref:
                assert torch.equal(tree[k][i], ref[k][i]), (i, k)
        for a, b in zip(stats, alone_stats):
            assert torch.equal(a[i], b[i])
    zero_lr = fresh()
    run(zero_lr, slice(None), None, lrs * act, None)
    short = int(np.argmin([p.num_batches for p in plans]))
    assert not torch.equal(zero_lr.trace["adapter.layers.3.weight"][short],
                           both.trace["adapter.layers.3.weight"][short])
    assert not torch.equal(zero_lr.buffers["adapter.layers.1.running_var"][short],
                           both.buffers["adapter.layers.1.running_var"][short])


# ------------------------------------------------------------ CSVs, resume --


def test_aggregate_csv_writes_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(0)
    keys = ("weighted_mean_acc", "worst_acc", "acc_0_0", "acc_0_1", "acc_1_0", "acc_1_1",
            "mean_acc")

    def d():
        return {k: float(rng.random()) for k in keys}

    results = [((d(), d(), d()), (d(), {k: v for k, v in d().items() if k != "acc_1_1"}))
               for _ in range(3)]
    trunner.aggregate_csv(results, str(tmp_path / "a" / "t.csv"))
    jrunner.aggregate_csv(results, str(tmp_path / "b" / "t.csv"))
    assert (tmp_path / "a" / "t.csv").read_bytes() == (tmp_path / "b" / "t.csv").read_bytes()
    cfg = dict(tl_method="adapter_reg_seq", epochs=4, epochs_feature_learning=2,
               continue_from_best=True, resample_ce=True, **BASE)
    assert trunner.cell_filename(TrainConfig(**cfg)) == jrunner.cell_filename(JaxConfig(**cfg))


def _with_jax_inits(monkeypatch):
    """The port's runner, its rows started from the JAX sweep's draws."""
    real = trunner.train_seeds_vmapped

    def run(cfg, bundle, seeds, cell_grid=None, **kw):
        n_cells = len(cell_grid) if cell_grid is not None else 1
        inits = jax_row_inits(JaxConfig(**{f: getattr(cfg, f) for f in
                                           cfg.__dataclass_fields__}), list(seeds) * n_cells)
        return real(cfg, bundle, seeds, cell_grid=cell_grid, inits=inits, **kw)

    monkeypatch.setattr(trunner, "train_seeds_vmapped", run)


def test_run_sweep_writes_the_jax_csvs(bundles, tmp_path, monkeypatch):
    jb, tb = bundles
    flags = dict(tl_method="adapter_reg_seq_alter", epochs=3, epochs_feature_learning=1,
                 add_adapter=True, **BASE)
    grid = dict(lr_list=[0.5, 2.0], lr_multiple=2.0, stack_lr_axis=True)
    ref = jrunner.run_sweep(JaxConfig(**flags), jb, SEEDS, **grid,
                            result_root=str(tmp_path / "jax"))
    _with_jax_inits(monkeypatch)
    ours = trunner.run_sweep(TrainConfig(**flags), tb, SEEDS, **grid,
                             result_root=str(tmp_path / "port"), device="cpu")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 2 and sorted(os.listdir(tmp_path / "port")) == names
    assert sorted(os.path.basename(p) for p in ours) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_resume_stacks_only_the_missing_cells(bundles, tmp_path, monkeypatch):
    _, tb = bundles
    cfg = TrainConfig(tl_method="adapter", epochs=2, **BASE)
    root = str(tmp_path / "r")
    grid = dict(lr_list=[0.5, 2.0], result_root=root, stack_lr_axis=True, device="cpu")
    first = trunner.run_sweep(cfg, tb, [42], **grid)
    assert len(first) == 2
    victim = sorted(first)[1]
    os.remove(victim)
    calls = []
    real = trunner.train_seeds_vmapped
    monkeypatch.setattr(trunner, "train_seeds_vmapped",
                        lambda *a, **kw: calls.append(kw["cell_grid"]) or real(*a, **kw))
    rerun = trunner.run_sweep(cfg, tb, [42], skip_existing=True, **grid)
    assert set(rerun) == {victim} and [len(c) for c in calls] == [1]
    assert rerun[victim] == first[victim]
    # a complete grid trains nothing
    assert trunner.run_sweep(cfg, tb, [42], skip_existing=True, **grid) == {}
    assert len(calls) == 1


def test_seeds_past_uint32_and_mesh(bundles):
    _, tb = bundles
    cfg = TrainConfig(tl_method="adapter", epochs=1, **BASE)
    big = [2 ** 32 + 5, 2 ** 33 + 7]
    seq = trunner.run_seeds(cfg, tb, big, use_vmap=False, device="cpu")
    vm = trunner.run_seeds(cfg, tb, big, use_vmap=True, device="cpu")
    assert seq == vm
    # a mesh of this one process (multi-rank meshes: test_torch_seed_mesh.py)
    from debiasing_multi_modal_tpu_torch.parallel import multihost
    from debiasing_multi_modal_tpu_torch.parallel.mesh import make_mesh

    with multihost.process_group("cpu"):
        mesh = make_mesh(device="cpu")
        assert trunner.run_seeds(cfg, tb, big, mesh=mesh, device="cpu") == vm
        with pytest.raises(ValueError, match="no 'data' axis"):
            trunner.run_seeds(cfg, tb, big, mesh=make_mesh((1, 1), ("model", "seq"),
                                                          device="cpu"), device="cpu")


# ---------------------------------------------------------------------- CLI --


def test_sweep_cli_on_caches_the_port_extracted(tmp_path, monkeypatch, capsys, synthetic_bpe):
    from debiasing_multi_modal_tpu.cli import sweep_main as jsweep
    from debiasing_multi_modal_tpu.utils import compilation_cache
    from debiasing_multi_modal_tpu_torch import models as tmodels
    from debiasing_multi_modal_tpu_torch.cli import extract_main as textract
    from debiasing_multi_modal_tpu_torch.cli import sweep_main as tsweep
    from debiasing_multi_modal_tpu_torch.models import CLIPConfig
    from test_torch_stage_b_loop import TINY_RN, _waterbirds_tree

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
             "--tl_method", "adapter_reg_seq_alter", "--add_adapter", "--epochs", "3",
             "--epochs_feature_learning", "1", "--batch_size", "8", "--adapter_feat_dim", "16",
             "--lr_list", "0.5,1.0", "--bsr_list", "2,4", "--lr_multiple", "1.0",
             "--num_iter", "2", "--stack_lr_axis", "--stack_bsr_axis"]
    monkeypatch.setattr(compilation_cache, "enable_persistent_cache", lambda: None)
    parse_jax = jsweep.extend_parser(jsweep.build_parser()).parse_args
    jsweep.main(parse_jax(flags + ["--result_root", str(tmp_path / "jax")]))
    _with_jax_inits(monkeypatch)
    parse = tsweep.extend_parser(tsweep.build_parser()).parse_args
    capsys.readouterr()
    assert tsweep.main(parse(flags + ["--result_root", str(tmp_path / "port"),
                                      "--device", "cpu"])) == 0
    out = capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 4 and sorted(os.listdir(tmp_path / "port")) == names
    assert out.count("wrote ") == 4
    # The CLI writes what the library writes.  (Against JAX the CSVs are
    # held byte for byte by test_run_sweep_writes_the_jax_csvs: a random tiny
    # CLIP on random pixels gives test embeddings within cosine ~0.999 of each
    # other, and one zero-shot probe of one row here sits at a logit margin of
    # 3e-5 of scale, where the port's sequential loop and its stacked sweep
    # agree with each other and f32 rounding flips one of 8 samples against
    # JAX.)
    bundle = tloop.bundle_from_files(
        "waterbirds", str(img_root), str(emb / "RN50" / "clip.npz"),
        str(emb / "clip_class.json"), str(emb / "clip_spurious.json"),
        str(emb / "clip_group.json"), device="cpu")
    cfg = tsweep.config_from_args(parse(flags)).replace(input_dim=bundle.text_class.shape[0])
    trunner.run_sweep(cfg, bundle, [42, 32], lr_list=[0.5, 1.0], bsr_list=[2, 4],
                      lr_multiple=1.0, stack_lr_axis=True, stack_bsr_axis=True,
                      result_root=str(tmp_path / "library"), device="cpu")
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "library" / name).read_bytes()
    with pytest.raises(SystemExit, match="drop --no_vmap"):
        tsweep.main(parse(flags + ["--no_vmap", "--device", "cpu"]))
    # --seed_mesh in one process: a group of one rank, the same bytes
    assert tsweep.main(parse(flags + ["--result_root", str(tmp_path / "mesh"),
                                      "--seed_mesh", "--device", "cpu"])) == 0
    for name in names:
        assert (tmp_path / "mesh" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
