"""The SupCon workspace's side workloads against the JAX package on the CPU
at f32: ``models/resnet_plain.py`` (a train-mode forward, the updated
BatchNorm statistics, the gradients and an eval-mode forward from the
updated statistics, the JAX weights carried across by
``weights/convert.py::plain_resnet_state_dict_from_jax``) and
``train/linear_eval.py`` (``linear_probe``'s parameters within 1e-5 and its
accuracy equal, with the step/cosine decay and warm-up knobs off and on;
``evaluate_linear``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu.data.synthetic import SyntheticSpec, make_synthetic_dataset
from debiasing_multi_modal_tpu.models import resnet_plain as jplain
from debiasing_multi_modal_tpu.train import linear_eval as jlin
from debiasing_multi_modal_tpu_torch.models import resnet_plain as tplain
from debiasing_multi_modal_tpu_torch.train import linear_eval as tlin
from debiasing_multi_modal_tpu_torch.weights.convert import plain_resnet_state_dict_from_jax


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= tol, err


@pytest.fixture(scope="module")
def plain():
    """A width-8 ResNet with one block a stage, its JAX variables made
    non-trivial (every BatchNorm's statistics and affine drawn), a batch and
    a target."""
    model = jplain.PlainResNet(layers=(1, 1, 1, 1), width=8)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((4, 64, 64, 3)), jnp.float32)
    variables = jax.jit(functools.partial(model.init, train=False))(jax.random.PRNGKey(0), x)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a if "kernel" in jax.tree_util.keystr(path)
        else jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype), variables["params"])
    stats = {"batch_stats": jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape)
                                    if "var" in jax.tree_util.keystr(path)
                                    else rng.uniform(-0.2, 0.2, a.shape), a.dtype),
        variables["batch_stats"])}
    variables = {"params": params, **stats}
    tgt = rng.standard_normal((4, 256)).astype(np.float32)
    return model, variables, np.asarray(x), tgt


def _port(variables):
    model = tplain.PlainResNet(layers=(1, 1, 1, 1), width=8)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in plain_resnet_state_dict_from_jax(variables).items()})
    return model


def test_plain_resnet_train_forward_and_statistics_match_jax(plain):
    jmodel, variables, x, _ = plain
    want, mutated = jax.jit(functools.partial(jmodel.apply, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    model = _port(variables).train()
    got = model(torch.from_numpy(x))
    assert got.shape == (4, 256) and got.dtype == torch.float32
    _close(got.detach().numpy(), want, 1e-5)
    updated = plain_resnet_state_dict_from_jax({"params": variables["params"], **mutated})
    state = model.state_dict()
    for k, v in updated.items():
        if k.endswith(("running_mean", "running_var")):
            _close(state[k].numpy(), v, 1e-5)
    # eval mode from the updated statistics, as the JAX module with them
    want_eval = jax.jit(functools.partial(jmodel.apply, train=False))(
        {"params": variables["params"], **mutated}, jnp.asarray(x))
    with torch.no_grad():
        _close(model.eval()(torch.from_numpy(x)).numpy(), want_eval, 1e-5)


def test_plain_resnet_gradients_match_jax(plain):
    jmodel, variables, x, tgt = plain

    def loss(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.mean((out - tgt) ** 2)

    jgrads = jax.jit(jax.grad(loss))(variables["params"])
    want = plain_resnet_state_dict_from_jax({"params": jgrads,
                                             "batch_stats": variables["batch_stats"]})
    model = _port(variables).train()
    out = model(torch.from_numpy(x))
    ((out - torch.from_numpy(tgt)) ** 2).mean().backward()
    # within 1e-4 at the scale of the largest gradient: the stem BatchNorm's bias has
    # none (every path from it meets a shift-invariant train-mode BatchNorm
    # behind 1x1 convolutions, past ReLUs that pass almost everything)
    scale = max(np.abs(v).max() for k, v in want.items() if k in dict(model.named_parameters()))
    for name, p in model.named_parameters():
        err = np.abs(p.grad.numpy() - want[name]).max() / scale
        assert err <= 1e-4, (name, err)


def test_resnet50_builds_the_jax_shapes():
    """``resnet50()``'s parameters and statistics have the JAX module's
    shapes, key for key (checked on the abstract JAX init, no compute)."""
    jmodel = jplain.resnet50()
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 64, 64, 3)), train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = plain_resnet_state_dict_from_jax(zeros)
    got = tplain.resnet50().state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k


@pytest.fixture(scope="module")
def features():
    _, table, _, _, _ = make_synthetic_dataset(
        SyntheticSpec(n_train=128, n_val=64, n_test=64, dim=16))
    return table


@pytest.mark.parametrize("knobs", [
    {},
    {"lr_decay_epochs": (2, 4), "lr_decay_rate": 0.5, "warm": True},
    {"cosine": True, "warm": True, "weight_decay": 1e-3},
], ids=["constant", "step_decay_warm", "cosine_warm_wd"])
def test_linear_probe_matches_jax(features, knobs):
    table = features
    train = table.split == 0
    kw = dict(epochs=5, learning_rate=0.5, batch_size=32, **knobs)
    want, want_acc = jlin.linear_probe(table.embeddings[train], table.y[train], **kw)
    got, got_acc = tlin.linear_probe(table.embeddings[train], table.y[train], device="cpu", **kw)
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-5)
    assert got_acc == pytest.approx(want_acc, abs=0.0)
    test = table.split == 2
    assert tlin.evaluate_linear(got, table.embeddings[test], table.y[test]) == \
        jlin.evaluate_linear(want, table.embeddings[test], table.y[test])
