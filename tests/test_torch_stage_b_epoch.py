"""One Stage-B epoch in the port (debiasing_multi_modal_tpu_torch/train/
steps.py ``train_epoch`` and ``eval_epoch``) against the JAX package's, f32
on the CPU: one initial state carried across
(``classifier_state_dict_from_jax_variables``), one batch plan with a padded
last batch, one per-batch learning-rate vector.

Covered: ``linear_probing`` (the TrainConfig default), the adapter with
class and with group targets, and the multiple classifier (the second
adapter, its old branch frozen by ``freeze_subtrees`` and starting from a
stale momentum trace) with class and group targets.  Parameters, momentum
trace and BatchNorm statistics agree within 1e-5 of each tensor's scale (an
epoch of f32 sums in two orders); the epoch's per-group ``corrects`` and
``counts`` are equal and ``loss_sum`` is within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu.data.synthetic import SyntheticSpec, make_synthetic_dataset
from debiasing_multi_modal_tpu.models import adapter as jadapter
from debiasing_multi_modal_tpu.train import steps as jsteps
from debiasing_multi_modal_tpu_torch.data.samplers import epoch_plan
from debiasing_multi_modal_tpu_torch.models import adapter as tadapter
from debiasing_multi_modal_tpu_torch.train import steps as tsteps
from debiasing_multi_modal_tpu_torch.weights.convert import (
    classifier_state_dict_from_jax_variables,
)

D, HIDDEN, BS = 64, 16, 96


@pytest.fixture(scope="module")
def data():
    _, table, text_class, text_group, _ = make_synthetic_dataset(SyntheticSpec(dim=D))
    train = table.split == 0
    return {"emb": table.embeddings[train], "y": table.y[train].astype(np.int32),
            "group": table.group[train].astype(np.int32), "class": text_class,
            "groups": text_group, "val_emb": table.embeddings[table.split == 1],
            "val_y": table.y[table.split == 1].astype(np.int32),
            "val_group": table.group[table.split == 1].astype(np.int32)}


def _sd(variables):
    return {k: v for k, v in classifier_state_dict_from_jax_variables(variables).items()
            if not k.endswith("num_batches_tracked")}


def _close_tree(ours, ref, rel=1e-5):
    """Each tensor within ``rel`` of its scale.  fc1's bias (``layers.0.bias``)
    feeds a BatchNorm, so its gradient is zero but for rounding: it and its
    trace stay at rounding noise, and are held to the scale of fc1's weight."""
    for k, r in ref.items():
        scale = np.abs(ref[k.replace("layers.0.bias", "layers.0.weight")]).max()
        np.testing.assert_allclose(np.asarray(ours[k], np.float64), np.asarray(r, np.float64),
                                   rtol=0, atol=rel * float(scale), err_msg=k)


CASES = {
    "linear_probing_class": ("linear", "class"),
    "adapter_class": ("adapter", "class"),
    "adapter_group": ("adapter", "group"),
    "second_adapter_class": ("multiple", "class"),
    "second_adapter_group": ("multiple", "group"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_and_eval_epoch_match_jax(data, case):
    kind, target = CASES[case]
    cols = 4 if target == "group" else 2
    if kind == "linear":
        jm, tm = jadapter.LinearClassifier(num_classes=cols), tadapter.LinearClassifier(D, cols)
    elif kind == "adapter":
        jm = jadapter.AdapterClassifier(hidden_dim=HIDDEN)
        tm = tadapter.AdapterClassifier(D, HIDDEN)
    else:
        jm = jadapter.MultipleAdapterClassifier(hidden_dim=HIDDEN)
        tm = tadapter.MultipleAdapterClassifier(D, HIDDEN)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.zeros((2, D)),
                                       jnp.zeros((D, cols)), mask=jnp.ones(2, bool),
                                       train=True))
    params, stats = variables["params"], variables.get("batch_stats", {})
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                        classifier_state_dict_from_jax_variables(variables).items()})
    jstate = jsteps.init_train_state(params, stats)
    tstate = tsteps.init_train_state(tm)
    if kind == "multiple":
        # a stale trace on every parameter: the frozen branch must ignore it
        rng = np.random.default_rng(8)
        trace = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        jstate = jsteps.TrainState(params, stats, trace)
        for k, v in _sd({"params": trace, "batch_stats": stats}).items():
            if k in tstate.trace:
                tstate.trace[k].copy_(torch.from_numpy(v))
        jmask = jsteps.freeze_subtrees(params, ("old",))
        tmask = tsteps.freeze_subtrees(tstate.params, ("old_cls",))
    else:
        jmask, tmask = jsteps.ones_mask(params), tsteps.ones_mask(tstate.params)

    labels = data["y"] if target == "class" else data["group"]
    text = data["class"] if target == "class" else data["groups"]
    plan = epoch_plan(len(labels), BS, True, np.random.default_rng(11))
    assert not plan.mask.all()  # the last batch is padded
    lrs = np.linspace(0.05, 0.5, plan.num_batches).astype(np.float32)

    jstate, jstats = jsteps.train_epoch(
        jm, jstate, jnp.asarray(data["emb"]), jnp.asarray(labels), jnp.asarray(data["group"]),
        jnp.asarray(plan.indices), jnp.asarray(plan.mask), jnp.asarray(lrs),
        jnp.asarray(text), jmask, n_groups=4, momentum=0.9, weight_decay=5e-5)
    tstate, tstats = tsteps.train_epoch(
        tstate, torch.from_numpy(data["emb"]), torch.from_numpy(labels),
        torch.from_numpy(data["group"]), torch.from_numpy(plan.indices),
        torch.from_numpy(plan.mask), lrs, torch.from_numpy(text), tmask,
        n_groups=4, momentum=0.9, weight_decay=5e-5)
    jstate = jax.device_get(jstate)

    ref = _sd({"params": jstate.params, "batch_stats": jstate.batch_stats})
    ours = {k: v for k, v in tm.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(ours) == set(ref)
    _close_tree({k: v.numpy() for k, v in ours.items()}, ref)
    ref_trace = _sd({"params": jstate.trace, "batch_stats": jstate.batch_stats})
    assert set(tstate.trace) == {k for k in ref_trace if "running" not in k}
    _close_tree({k: v.numpy() for k, v in tstate.trace.items()},
                {k: v for k, v in ref_trace.items() if "running" not in k})
    if kind == "multiple":
        for k, t in tstate.trace.items():
            if k.startswith("old_cls."):
                assert not t.any()
    np.testing.assert_array_equal(tstats.corrects.numpy(), np.asarray(jstats.corrects))
    np.testing.assert_array_equal(tstats.counts.numpy(), np.asarray(jstats.counts))
    assert tstats.n.item() == float(jstats.n) == len(labels)
    np.testing.assert_allclose(tstats.loss_sum.item(), float(jstats.loss_sum), rtol=1e-5)

    # eval with the trained state and its running statistics
    val_labels = data["val_y"] if target == "class" else data["val_group"]
    eplan = epoch_plan(len(val_labels), BS, False)
    jeval = jsteps.eval_epoch(
        jm, jstate.params, jstate.batch_stats, jnp.asarray(data["val_emb"]),
        jnp.asarray(val_labels), jnp.asarray(data["val_group"]), jnp.asarray(eplan.indices),
        jnp.asarray(eplan.mask), jnp.asarray(text), n_groups=4)
    teval = tsteps.eval_epoch(
        tm, torch.from_numpy(data["val_emb"]), torch.from_numpy(val_labels),
        torch.from_numpy(data["val_group"]), torch.from_numpy(eplan.indices),
        torch.from_numpy(eplan.mask), torch.from_numpy(text), n_groups=4)
    np.testing.assert_array_equal(teval.corrects.numpy(), np.asarray(jeval.corrects))
    np.testing.assert_array_equal(teval.counts.numpy(), np.asarray(jeval.counts))
    np.testing.assert_allclose(teval.loss_sum.item(), float(jeval.loss_sum), rtol=1e-5)
    merged = tstats.merge(teval)
    assert merged.n.item() == len(labels) + len(val_labels)
