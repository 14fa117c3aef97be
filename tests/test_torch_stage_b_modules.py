"""Stage B's modules in the port (debiasing_multi_modal_tpu_torch/models/
adapter.py, train/{losses,metrics,schedules,steps,checkpoint}.py,
data/{samplers,synthetic}.py, utils/{staging,seed,trees}.py,
weights/convert.py) against the JAX package's, f32 on the CPU, on seeded
numpy inputs and one set of weights carried across by
``classifier_state_dict_from_jax_variables``.

Tolerances: 1e-6 of each output's scale for the modules and the SGD step
(f32 sum order); the samplers, the synthetic data and the schedules are
equal bit for bit (the port copies their numpy code and draws in the same
order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu.data import samplers as jsamplers
from debiasing_multi_modal_tpu.data import synthetic as jsynthetic
from debiasing_multi_modal_tpu.models import adapter as jadapter
from debiasing_multi_modal_tpu.train import losses as jlosses
from debiasing_multi_modal_tpu.train import metrics as jmetrics
from debiasing_multi_modal_tpu.train import schedules as jschedules
from debiasing_multi_modal_tpu.train import steps as jsteps
from debiasing_multi_modal_tpu.train.config import TrainConfig as JaxConfig
from debiasing_multi_modal_tpu.weights.convert import adapter_variables_to_torch
from debiasing_multi_modal_tpu_torch.data import samplers as tsamplers
from debiasing_multi_modal_tpu_torch.data import synthetic as tsynthetic
from debiasing_multi_modal_tpu_torch.models import adapter as tadapter
from debiasing_multi_modal_tpu_torch.train import checkpoint as tckpt
from debiasing_multi_modal_tpu_torch.train import losses as tlosses
from debiasing_multi_modal_tpu_torch.train import metrics as tmetrics
from debiasing_multi_modal_tpu_torch.train import schedules as tschedules
from debiasing_multi_modal_tpu_torch.train import steps as tsteps
from debiasing_multi_modal_tpu_torch.train.config import TL_METHODS, TrainConfig
from debiasing_multi_modal_tpu_torch.utils.seed import set_seed
from debiasing_multi_modal_tpu_torch.utils.staging import DeviceCache
from debiasing_multi_modal_tpu_torch.utils.trees import host_copy
from debiasing_multi_modal_tpu_torch.weights.convert import (
    classifier_state_dict_from_jax_variables,
    jax_variables_from_classifier_state_dict,
)

D, HIDDEN = 32, 8


def _close(ours, ref, rel=1e-6):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * max(float(np.abs(ref).max()), 1e-30))


def _jax_init(module, text_cols=2, seed=0):
    variables = module.init(jax.random.PRNGKey(seed), jnp.zeros((2, D)), jnp.zeros((D, text_cols)),
                            mask=jnp.ones(2, bool), train=True)
    return jax.device_get(variables)


def _perturbed_stats(stats, rng):
    """Non-trivial running statistics (mean ~ N(0, 0.1^2), var ~ U(0.5, 1.5)),
    so eval mode tests something."""
    if "mean" in stats:
        return {"mean": (0.1 * rng.standard_normal(stats["mean"].shape)).astype(np.float32),
                "var": (0.5 + rng.random(stats["var"].shape)).astype(np.float32)}
    return {k: _perturbed_stats(v, rng) for k, v in stats.items()}


def _port(module, variables):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                            classifier_state_dict_from_jax_variables(variables).items()})
    return module


def _inputs(rng, rows=12, text_cols=2):
    x = rng.standard_normal((rows, D)).astype(np.float32)
    text = rng.standard_normal((D, text_cols)).astype(np.float32)
    mask = np.ones(rows, bool)
    mask[-5:] = False
    return x, text, mask


def test_masked_batchnorm_matches_jax_in_train_and_eval():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((10, HIDDEN)) * 3 + 1).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1, 0, 0], bool)
    jbn = jadapter.MaskedBatchNorm(HIDDEN)
    variables = {"params": {"scale": rng.standard_normal(HIDDEN).astype(np.float32),
                            "bias": rng.standard_normal(HIDDEN).astype(np.float32)},
                 "batch_stats": {"mean": rng.standard_normal(HIDDEN).astype(np.float32),
                                 "var": rng.random(HIDDEN).astype(np.float32) + 0.5}}
    tbn = tadapter.MaskedBatchNorm(HIDDEN)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        tbn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        tbn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        tbn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    for step_mask in (mask, None, np.zeros(10, bool)):  # partial, none, all padded
        ref, mutated = jbn.apply(variables, jnp.asarray(x), mask=step_mask, train=True,
                                 mutable=["batch_stats"])
        variables = {"params": variables["params"], **jax.device_get(mutated)}
        ours = tbn.train()(torch.from_numpy(x),
                           None if step_mask is None else torch.from_numpy(step_mask))
        _close(ours.detach().numpy(), ref)
        _close(tbn.running_mean.numpy(), variables["batch_stats"]["mean"])
        _close(tbn.running_var.numpy(), variables["batch_stats"]["var"])
    ref = jbn.apply(variables, jnp.asarray(x), mask=mask, train=False)
    _close(tbn.eval()(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy(), ref)
    assert int(tbn.num_batches_tracked) == 0


@pytest.mark.parametrize("kind", ["adapter", "multiple", "linear"])
def test_classifiers_match_jax(kind):
    """Logits in train mode (with a partial mask; the BatchNorm statistics
    after it) and in eval mode, and the gradient of the masked CE."""
    rng = np.random.default_rng(1)
    cols = 4 if kind == "multiple" else 2
    x, text, mask = _inputs(rng, text_cols=cols)
    if kind == "adapter":
        jm = jadapter.AdapterClassifier(hidden_dim=HIDDEN)
        tm = tadapter.AdapterClassifier(D, HIDDEN)
    elif kind == "multiple":
        jm = jadapter.MultipleAdapterClassifier(hidden_dim=HIDDEN)
        tm = tadapter.MultipleAdapterClassifier(D, HIDDEN)
    else:
        jm = jadapter.LinearClassifier(num_classes=2)
        tm = tadapter.LinearClassifier(D, 2)
    variables = _jax_init(jm, cols)
    if "batch_stats" in variables:
        variables = {**variables, "batch_stats": _perturbed_stats(variables["batch_stats"], rng)}
    _port(tm, variables)
    labels = rng.integers(0, cols, len(x)).astype(np.int32)

    def jloss(params):
        logits, mutated = jm.apply({**variables, "params": params}, jnp.asarray(x),
                                   jnp.asarray(text), mask=jnp.asarray(mask), train=True,
                                   mutable=["batch_stats"])
        return jlosses.masked_cross_entropy(logits, jnp.asarray(labels), jnp.asarray(mask)), \
            (logits, mutated)

    (jl, (jlogits, mutated)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    tm.train()
    logits = tm(torch.from_numpy(x), torch.from_numpy(text), torch.from_numpy(mask))
    loss = tlosses.masked_cross_entropy(logits, torch.from_numpy(labels), torch.from_numpy(mask))
    loss.backward()
    _close(logits.detach().numpy(), jlogits)
    _close(loss.item(), jl)
    grads = classifier_state_dict_from_jax_variables(
        {"params": jgrads, "batch_stats": mutated.get("batch_stats", {})})
    # gradients to 1e-6 of the largest: fc1's bias feeds a BatchNorm, so its
    # gradient is zero but for rounding, and its own scale is noise
    scale = max(float(np.abs(g).max()) for n, g in grads.items() if "running" not in n)
    for name, p in tm.named_parameters():
        if name.startswith("old_cls."):
            assert p.grad is None  # the frozen branch is detached
            continue
        np.testing.assert_allclose(p.grad.numpy(), grads[name], rtol=0, atol=1e-6 * scale)
    for name, buf in tm.named_buffers():  # the statistics after the step
        if not name.endswith("num_batches_tracked"):
            _close(buf.numpy(), grads[name])
    ref = jm.apply({**variables, **mutated}, jnp.asarray(x), jnp.asarray(text),
                   mask=jnp.asarray(mask), train=False)
    with torch.no_grad():
        _close(tm.eval()(torch.from_numpy(x), torch.from_numpy(text),
                         torch.from_numpy(mask)).numpy(), ref)


def test_zero_shot_logits_and_masked_cross_entropy_match_jax():
    rng = np.random.default_rng(2)
    x, text, mask = _inputs(rng, rows=9, text_cols=4)
    ref = jadapter.zero_shot_logits(jnp.asarray(x), jnp.asarray(text), 0.01)
    ours = tadapter.zero_shot_logits(torch.from_numpy(x), torch.from_numpy(text), 0.01)
    _close(ours.numpy(), ref)
    labels = rng.integers(0, 4, 9).astype(np.int32)
    for m in (mask, None, np.zeros(9, bool)):  # partial, none, all padded
        ref = jlosses.masked_cross_entropy(jnp.asarray(ours.numpy()), jnp.asarray(labels),
                                           None if m is None else jnp.asarray(m))
        got = tlosses.masked_cross_entropy(ours, torch.from_numpy(labels),
                                           None if m is None else torch.from_numpy(m))
        _close(got.item(), ref)


def test_sgd_with_freeze_mask_and_stale_trace_matches_jax():
    """The mask gates the whole update: a frozen parameter with a stale
    nonzero trace does not move and its trace becomes zero."""
    rng = np.random.default_rng(3)
    jm = jadapter.MultipleAdapterClassifier(hidden_dim=HIDDEN)
    params = _jax_init(jm, 4)["params"]
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    trace = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    mask = jsteps.freeze_subtrees(params, ("old",))
    new_p, new_t = jax.device_get(jsteps._sgd(params, grads, trace, 0.37, 0.9, 5e-5, mask))

    no_stats = {b: {"bn": {"mean": np.zeros(HIDDEN), "var": np.zeros(HIDDEN)}}
                for b in ("old", "new")}

    def sd(tree):  # a parameter tree under the port's names
        out = classifier_state_dict_from_jax_variables({"params": tree, "batch_stats": no_stats})
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()
                if "running" not in k and "num_batches" not in k}

    tp, tg, tt = sd(params), sd(grads), sd(trace)
    old_before = {k: v.clone() for k, v in tp.items() if k.startswith("old_cls.")}
    tmask = tsteps.freeze_subtrees(tp, ("old_cls",))
    assert sorted(k for k, m in tmask.items() if m == 0.0) == sorted(old_before)
    tsteps._sgd(tp, tg, tt, 0.37, 0.9, 5e-5, tmask)
    rp, rt = sd(new_p), sd(new_t)
    for k in tp:
        _close(tp[k].numpy(), rp[k].numpy())
        _close(tt[k].numpy(), rt[k].numpy())
    for k, v in old_before.items():
        assert torch.equal(tp[k], v) and not tt[k].any()
    with pytest.raises(ValueError, match="0 or 1"):
        tsteps._sgd(tp, tg, tt, 0.1, 0.9, 0.0, {k: 0.5 for k in tp})


@pytest.mark.parametrize("flags", [
    dict(warm=True), dict(warm_reg=True, epochs_feature_learning=3),
    dict(cosine=True, warm=True, warm_reg=True, epochs_feature_learning=4, lr_decay_rate=0.1),
    dict(lr_decay_epochs=(2, 5), lr_decay_rate=0.1, epochs_feature_learning=3),
])
def test_epoch_batch_lrs_equal_jax(flags):
    kw = dict(tl_method="adapter_reg_seq", epochs=12, learning_rate=0.7,
              learning_rate_reg=0.3, **flags)
    kw.setdefault("epochs_feature_learning", 2)
    jc, tc = JaxConfig(**kw), TrainConfig(**kw)
    for epoch in range(1, 13):
        for phase in (1, 2):
            np.testing.assert_array_equal(tschedules.epoch_batch_lrs(tc, epoch, 7, phase),
                                          jschedules.epoch_batch_lrs(jc, epoch, 7, phase))


def test_config_is_the_jax_config():
    assert TL_METHODS == __import__(
        "debiasing_multi_modal_tpu.train.config", fromlist=["TL_METHODS"]).TL_METHODS
    for kw in (dict(tl_method="adapter_reg_seq_alter", epochs_feature_learning=2, cosine=True,
                    epochs=7, dataset="celeba"), dict()):
        jc, tc = JaxConfig(**kw), TrainConfig(**kw)
        for name in ("warmup_to", "warmup_to_reg", "warm_epochs_reg", "is_two_phase",
                     "is_reg_method"):
            assert getattr(tc, name) == getattr(jc, name)
        assert [tc.use_group_prompt(e) for e in range(6)] == \
            [jc.use_group_prompt(e) for e in range(6)]
    with pytest.raises(ValueError):
        TrainConfig(tl_method="adapter", add_adapter=True)


def test_samplers_are_bit_equal_to_jax():
    rng = np.random.default_rng(4)
    groups = rng.integers(0, 4, 203).astype(np.int32)
    labels = groups // 2
    zs = rng.integers(0, 2, 203).astype(np.int32)
    for a, b in zip(tsamplers.stratified_split_indices(groups, 0.5, seed=42),
                    jsamplers.stratified_split_indices(groups, 0.5, seed=42)):
        np.testing.assert_array_equal(a, b)
    for ours, ref in ((np.random.default_rng(7), np.random.default_rng(7)),):
        for _ in range(3):
            np.testing.assert_array_equal(tsamplers.balanced_subset_indices(groups, ours, 4),
                                          jsamplers.balanced_subset_indices(groups, ref, 4))
        w = tsamplers.resampled_ce_weights(labels, zs, 2)
        np.testing.assert_array_equal(w, jsamplers.resampled_ce_weights(labels, zs, 2))
        np.testing.assert_array_equal(
            tsamplers.resampled_ce_weights(labels, zs, 2, reweighting_by_class=True),
            jsamplers.resampled_ce_weights(labels, zs, 2, reweighting_by_class=True))
        np.testing.assert_array_equal(tsamplers.weighted_sample_indices(w, 203, ours),
                                      jsamplers.weighted_sample_indices(w, 203, ref))
        for drop_last in (False, True):
            order = ours.permutation(203)
            np.testing.assert_array_equal(order, ref.permutation(203))
            a = tsamplers.make_batch_plan(order, 32, drop_last)
            b = jsamplers.make_batch_plan(order, 32, drop_last)
            np.testing.assert_array_equal(a.indices, b.indices)
            np.testing.assert_array_equal(a.mask, b.mask)
            assert (a.num_batches, a.batch_size, a.num_examples) == \
                (b.num_batches, b.batch_size, b.num_examples)
        a = tsamplers.epoch_plan(203, 64, True, ours)
        b = jsamplers.epoch_plan(203, 64, True, ref)
        np.testing.assert_array_equal(a.indices, b.indices)
        assert ours.bit_generator.state == ref.bit_generator.state
    cache = {}
    split = list(range(50))
    first = tsamplers.cached_eval_plan(cache, split, 16, np.array)
    assert tsamplers.cached_eval_plan(cache, split, 16, np.array) is first
    np.testing.assert_array_equal(first[0], jsamplers.epoch_plan(50, 16, False).indices)


def test_synthetic_dataset_is_the_jax_dataset():
    spec = dict(dim=16, n_train=40, n_val=20, n_test=24, seed=3)
    ours = tsynthetic.make_synthetic_dataset(tsynthetic.SyntheticSpec(**spec))
    ref = jsynthetic.make_synthetic_dataset(jsynthetic.SyntheticSpec(**spec))
    for a, b in zip(ours[2:], ref[2:]):
        np.testing.assert_array_equal(a, b)
    for col in ("filenames", "y", "place", "group", "split", "y_pred", "embeddings"):
        np.testing.assert_array_equal(getattr(ours[1], col), getattr(ref[1], col))


def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((20, 2)).astype(np.float32)
    logits[3] = [0.5, 0.5]  # a tie: the first maximum wins in both
    labels = rng.integers(0, 2, 20).astype(np.int32)
    groups = rng.integers(0, 4, 20).astype(np.int32)
    mask = rng.random(20) < 0.8
    ours = tmetrics.batch_group_counts(*(torch.from_numpy(a) for a in (logits, labels, groups,
                                                                        mask)), 4)
    ref = jmetrics.batch_group_counts(*(jnp.asarray(a) for a in (logits, labels, groups, mask)),
                                      4)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ratio = np.array([0.4, 0.1, 0.1, 0.4])
    for counts in (np.asarray(ref[1]), np.array([3.0, 0.0, 5.0, 1.0])):
        a = tmetrics.results_from_counts(np.asarray(ref[0]).clip(max=counts), counts, 2, ratio)
        b = jmetrics.results_from_counts(np.asarray(ref[0]).clip(max=counts), counts, 2, ratio)
        assert a == b and tmetrics.ordered(a) == jmetrics.ordered(b)


@pytest.mark.parametrize("kind", ["adapter", "multiple", "linear"])
def test_classifier_conversion_round_trips_and_matches_jax_export(kind):
    jm = {"adapter": jadapter.AdapterClassifier(hidden_dim=HIDDEN),
          "multiple": jadapter.MultipleAdapterClassifier(hidden_dim=HIDDEN),
          "linear": jadapter.LinearClassifier(num_classes=2)}[kind]
    variables = _jax_init(jm)
    sd = classifier_state_dict_from_jax_variables(variables)
    tm = {"adapter": tadapter.AdapterClassifier(D, HIDDEN),
          "multiple": tadapter.MultipleAdapterClassifier(D, HIDDEN),
          "linear": tadapter.LinearClassifier(D, 2)}[kind]
    assert set(sd) == set(tm.state_dict())
    if kind != "linear":  # the JAX package's own export, key for key
        ref = adapter_variables_to_torch(variables)
        assert set(ref) == set(sd)
        for k in ref:
            np.testing.assert_array_equal(sd[k], ref[k])
    _port(tm, variables)
    back = jax_variables_from_classifier_state_dict(tm.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, dict(variables)))


def test_seeded_init_is_device_independent_and_torch_shaped():
    np_rng, gen = set_seed(5)
    assert np_rng.bit_generator.state == np.random.default_rng(5).bit_generator.state
    a = tadapter.AdapterClassifier(64, 16, generator=gen)
    b = tadapter.AdapterClassifier(64, 16, generator=torch.Generator().manual_seed(5))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    w = a.adapter.layers[0].weight
    assert w.abs().max() <= 1 / 8 and w.abs().max() > 0.1  # U(-1/sqrt(64), 1/sqrt(64))


def test_staging_and_trees():
    cache = DeviceCache("cpu")
    arr = np.arange(6, dtype=np.int32)
    t = cache(arr)
    assert cache(arr) is t and len(cache) == 1 and t.dtype == torch.int32
    assert cache(t) is t  # a tensor on the device passes through
    cache.clear()
    assert len(cache) == 0
    tree = host_copy({"a": torch.ones(2, requires_grad=True), "b": [torch.zeros(1), 3]})
    assert tree["a"].device.type == "cpu" and not tree["a"].requires_grad
    assert tree["b"][1] == 3 and torch.equal(tree["b"][0], torch.zeros(1))


def test_checkpoint_files_prune_and_resume_layout(tmp_path):
    rng = np.random.default_rng(9)
    rng.random(3)
    d = str(tmp_path / "ck")
    for epoch in (1, 2, 3):
        tckpt.save_checkpoint(d, epoch, {"state": {"w": torch.full((2,), float(epoch))}},
                              rng, meta_extra={"history": {"x": [epoch]}})
    assert sorted(os.listdir(d)) == ["ep00002", "ep00003"]
    os.makedirs(os.path.join(d, "ep00004"))  # half written: no host_meta.json
    step = tckpt.latest_checkpoint(d)
    assert step.endswith("ep00003")
    epoch, tree, meta = tckpt.load_checkpoint(step)
    assert epoch == 3 and torch.equal(tree["state"]["w"], torch.full((2,), 3.0))
    assert meta["keys"] == ["state"] and meta["history"] == {"x": [3]}
    restored = tckpt.restore_rng(meta["rng_state"])
    assert restored.random() == rng.random()
    with open(os.path.join(step, "host_meta.json")) as f:
        assert json.load(f)["epoch"] == 3
    tckpt.save_checkpoint(d, 5, {"state": {}}, rng)
    assert sorted(os.listdir(d)) == ["ep00003", "ep00005"]  # the junk dir went too
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None
