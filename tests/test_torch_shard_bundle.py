"""Stage B data-parallel (``train/loop.py::shard_bundle``) on 2 gloo ranks:
every rank's result dicts and history equal the unsharded port run's and the
JAX package's ``shard_bundle`` run's (from the JAX loop's own initial
weights), and the best model the ranks save is the unsharded run's within
1e-5 of each tensor's scale (fc1's bias at its weight's) (the masked BatchNorm sums, the losses, the
gradients and the meters are all-reduced, so only their order differs)."""

import os

import jax
import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu.data.synthetic import SyntheticSpec as JaxSpec
from debiasing_multi_modal_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from debiasing_multi_modal_tpu.parallel.mesh import make_mesh as jax_mesh
from debiasing_multi_modal_tpu.train import loop as jloop
from debiasing_multi_modal_tpu.train.config import TrainConfig as JaxConfig
from debiasing_multi_modal_tpu_torch.parallel import multihost
from debiasing_multi_modal_tpu_torch.train import loop as tloop
from debiasing_multi_modal_tpu_torch.train.config import TrainConfig

import torch_parallel_worker as worker
from test_torch_stage_b_loop import _jax_init

SPEC = dict(dim=64, n_train=250, n_val=126, n_test=130)  # no split divides 4 rows
BASE = dict(dataset="waterbirds", input_dim=64, adapter_feat_dim=16, batch_size=128,
            batch_size_reg=32, learning_rate=0.5, learning_rate_reg=0.5,
            lr_decay_epochs=(100,), random_seed=42, epochs=4)
RUNS = {
    "flagship": dict(tl_method="adapter_reg_seq_alter", epochs_feature_learning=2,
                     add_adapter=True, warm_reg=True, balance_val=True),
    "adapter_reg": dict(tl_method="adapter_reg"),
    "linear_probing": dict(tl_method="linear_probing", resample_ce=True),
}


def _splits(meta):
    return {n: meta.take(np.where(meta.split == s)[0])
            for n, s in (("train", 0), ("val", 1), ("test", 2))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_bundle")
    meta, table, tc, tg, ts = jax_synthetic(JaxSpec(**SPEC))
    jb = jloop.shard_bundle(jloop.bundle_from_embedding_table(table, _splits(meta), tc, ts, tg),
                            jax_mesh((2,), ("data",), devices=jax.devices()[:2]))
    inits, jax_runs = {}, {}
    for label, flags in RUNS.items():
        jcfg = JaxConfig(**BASE, **flags)
        inits[label] = _jax_init(jcfg)
        if jcfg.tl_method == "linear_probing" or jcfg.resample_ce:
            jax_runs[label] = jloop.train_all_epochs(jcfg, jb, verbose=False)
        else:
            capture = {}
            jax_runs[label] = jloop.train_all_epochs(jcfg, jb, verbose=False, capture=capture)
            inits[label] = capture
    jobs = [(label, {**BASE, **flags, "save_results": True}, inits[label])
            for label, flags in RUNS.items()]
    ranks = multihost.launch(worker.shard_bundle_runs, 2,
                             args=(SPEC, jobs, str(root / "sharded")), timeout_s=240)
    bundle = worker._bundle(SPEC, shard=False)
    unsharded = {label: tloop.train_all_epochs(TrainConfig(**flags), bundle, verbose=False,
                                               init=init,
                                               results_dir=str(root / "unsharded" / label),
                                               device="cpu")
                 for label, flags, init in jobs}
    return root, jax_runs, ranks, unsharded


@pytest.mark.parametrize("label", sorted(RUNS))
def test_sharded_run_equals_unsharded_and_jax(runs, label):
    _, jax_runs, ranks, unsharded = runs
    best_ref, zs_ref, hist_ref = jax_runs[label]
    for rank in ranks:
        best, zs, hist = rank[label]
        assert (best, zs, hist) == tuple(unsharded[label])
        for split in ("train", "val", "test"):
            assert hist[split] == hist_ref[split], split
        assert best == best_ref and zs == zs_ref


@pytest.mark.parametrize("label", sorted(RUNS))
def test_sharded_best_model_within_1e5_of_unsharded(runs, label):
    root = runs[0]
    (name,) = [f for f in os.listdir(root / "unsharded" / label) if f.endswith(".pt")]
    ours = torch.load(root / "sharded" / label / name)
    ref = torch.load(root / "unsharded" / label / name)
    assert ours.keys() == ref.keys()
    for k, r in ref.items():
        if r.is_floating_point():
            # fc1's bias feeds a BatchNorm: its gradient is zero but for
            # rounding, so it is held to the scale of fc1's weight (as the
            # Stage-B parity tests and chip_smoke.py hold it)
            scale = ref[k.replace("layers.0.bias", "layers.0.weight")].abs().max().item()
            assert (ours[k] - r).abs().max().item() <= 1e-5 * scale, k
        else:
            assert torch.equal(ours[k], r), k
