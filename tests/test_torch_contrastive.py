"""The contrastive adapter in the port (debiasing_multi_modal_tpu_torch/
train/losses.py ``supcon_loss``, models/adapter.py ``CAEncoder``,
data/contrastive.py, train/contrastive.py and the loop's
``contrastive_adapter`` mode) against the JAX package's, f32 on the CPU.

- ``supcon_loss`` and its gradient within 1e-6 of scale, at the default
  temperature and at 0.01, where the naive ``log(exp_pos)`` form gives -inf.
- ``CAEncoder`` with and without its head from one JAX state, the head's
  conversion both ways.
- Every function of data/contrastive.py bit-equal from one numpy generator:
  the slices, the pools with the two-slice easy negatives, ``clamp_counts``,
  the rows (balanced and not, with the skipped-anchor warning) and the
  all-correct ``ValueError``.
- One contrastive epoch from one state and one row tensor: the encoder's
  parameters, trace and BatchNorm statistics within 1e-5 of each tensor's
  scale, the mean loss within 1e-5 relative.
- Whole ``train_all_epochs`` runs (``ca_ce_update`` -1, 1 and 0, and the
  linear head) from the JAX package's initial draws, rebuilt as its loop
  makes them: equal per-epoch result dicts, best epoch and zero-shot dicts,
  ``cl_loss`` within 1e-5 relative.
- A contrastive run resumed at epoch 2 equals the uninterrupted run bit for
  bit, the head's parameters and momentum included.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu.data import contrastive as jdata
from debiasing_multi_modal_tpu.data.synthetic import SyntheticSpec as JaxSpec
from debiasing_multi_modal_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from debiasing_multi_modal_tpu.models import adapter as jadapter
from debiasing_multi_modal_tpu.train import contrastive as jcontrastive
from debiasing_multi_modal_tpu.train import loop as jloop
from debiasing_multi_modal_tpu.train import losses as jlosses
from debiasing_multi_modal_tpu.train import steps as jsteps
from debiasing_multi_modal_tpu.train.config import TrainConfig as JaxConfig
from debiasing_multi_modal_tpu_torch.data import contrastive as tdata
from debiasing_multi_modal_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_dataset
from debiasing_multi_modal_tpu_torch.models import adapter as tadapter
from debiasing_multi_modal_tpu_torch.train import checkpoint as tckpt
from debiasing_multi_modal_tpu_torch.train import contrastive as tcontrastive
from debiasing_multi_modal_tpu_torch.train import loop as tloop
from debiasing_multi_modal_tpu_torch.train import losses as tlosses
from debiasing_multi_modal_tpu_torch.train import steps as tsteps
from debiasing_multi_modal_tpu_torch.train.config import TrainConfig
from debiasing_multi_modal_tpu_torch.weights.convert import (
    ca_head_state_dict_from_jax,
    classifier_state_dict_from_jax_variables,
    jax_ca_head_from_state_dict,
)

D, HIDDEN = 64, 16


# ------------------------------------------------------------------ modules --


@pytest.mark.parametrize("temperature", [0.1, 0.01])
def test_supcon_loss_and_gradient_match_jax(temperature):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((5, 12)).astype(np.float32)
    p = rng.standard_normal((5, 4, 12)).astype(np.float32)
    n = rng.standard_normal((5, 6, 12)).astype(np.float32)
    if temperature == 0.01:
        # a positive nearly opposite its anchor: pos - max_pos ~ -200 < -88,
        # where exp underflows and log(exp_pos) would be -inf
        p[0, 1] = -a[0] + 0.01 * p[0, 1]
        p[0, 0] = a[0]

        def norm(x):
            return x / np.linalg.norm(x, axis=-1, keepdims=True)

        pos = (norm(p[0]) @ norm(a[0])) / np.float32(temperature)
        with np.errstate(divide="ignore"):
            assert np.isneginf(np.log(np.exp(pos - pos.max()))).any()  # the naive form
    ref, ref_grads = jax.value_and_grad(jlosses.supcon_loss, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(p), jnp.asarray(n), temperature)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (a, p, n)]
    loss = tlosses.supcon_loss(*ts, temperature)
    grads = torch.autograd.grad(loss, ts)
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    for g, r in zip(grads, ref_grads):
        r = np.asarray(r)
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-6 * np.abs(r).max())
    # the stacked form: one loss per leading row
    stacked = tlosses.supcon_loss(*(torch.from_numpy(np.stack([x, x])) for x in (a, p, n)),
                                  temperature)
    assert stacked.shape == (2,) and torch.equal(stacked[0], stacked[1])
    np.testing.assert_allclose(stacked[0].item(), float(ref), rtol=1e-6)


def _jax_encoder_vars(ca_head, seed=3):
    enc = jadapter.CAEncoder(hidden_dim=HIDDEN, ca_head=ca_head, ca_feat_dim=8)
    return enc, jax.device_get(enc.init(jax.random.PRNGKey(seed), jnp.zeros((2, D)),
                                        train=True))


def _encoder_sd(variables):
    """A JAX CAEncoder's variables -> the port encoder's state dict."""
    out = {k: torch.from_numpy(np.array(v)) for k, v in classifier_state_dict_from_jax_variables(
        {"params": {"adapter": variables["params"]["adapter"]},
         "batch_stats": variables["batch_stats"]}).items()}
    if "head" in variables["params"]:
        out.update({k: torch.from_numpy(v) for k, v in
                    ca_head_state_dict_from_jax(variables["params"]["head"]).items()})
    return out


@pytest.mark.parametrize("ca_head", [None, "linear"])
def test_ca_encoder_matches_jax(ca_head):
    enc, variables = _jax_encoder_vars(ca_head)
    ours = tadapter.CAEncoder(D, HIDDEN, ca_head, 8)
    ours.load_state_dict(_encoder_sd(variables))
    x = np.random.default_rng(2).standard_normal((10, D)).astype(np.float32)
    mask = np.arange(10) < 7
    for train in (False, True):
        ref, _ = enc.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask), train=train,
                           mutable=["batch_stats"])
        with torch.no_grad():
            got = ours.train(train)(torch.from_numpy(x), torch.from_numpy(mask))
        assert got.shape == ((10, 8) if ca_head else (10, D))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(ref)).max())
    if ca_head:
        back = jax_ca_head_from_state_dict(ours.state_dict())
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(back[k], np.asarray(variables["params"]["head"][k]))
        assert ours.head.weight.shape == (8, D)
    else:
        assert ours.head is None
    # the encoder around a classifier's adapter trains that adapter in place
    cls = tadapter.AdapterClassifier(D, HIDDEN)
    assert tadapter.CAEncoder(D, HIDDEN, adapter=cls.adapter).adapter is cls.adapter
    with pytest.raises(ValueError, match="unknown ca_head"):
        tadapter.CAEncoder(D, HIDDEN, "mlp")


# --------------------------------------------------------------------- data --


def _labels_preds(seed, n=300, p_correct=0.8):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    preds = np.where(rng.random(n) < p_correct, labels, 1 - labels)
    return labels, preds


def _points_equal(a, b):
    assert len(a.slice_anchors) == len(b.slice_anchors)
    for x, y in zip(a.slice_anchors + a.slice_negatives, b.slice_anchors + b.slice_negatives):
        assert set(x) == set(y)
        for k in x:
            if k == "ix_by_class":
                assert x[k].keys() == y[k].keys()
                for c in x[k]:
                    np.testing.assert_array_equal(x[k][c], y[k][c])
            else:
                np.testing.assert_array_equal(x[k], y[k])
    assert a.positives_by_class.keys() == b.positives_by_class.keys()
    for c in a.positives_by_class:
        np.testing.assert_array_equal(a.positives_by_class[c]["ix"],
                                      b.positives_by_class[c]["ix"])


@pytest.mark.parametrize("balance", [True, False])
def test_contrastive_data_is_bit_equal(balance):
    labels, preds = _labels_preds(4)
    for got, ref in zip(tdata.compute_slices(labels, preds), jdata.compute_slices(labels, preds)):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    tp, jp = tdata.prepare_contrastive_points(labels, preds), \
        jdata.prepare_contrastive_points(labels, preds)
    _points_equal(tp, jp)
    # two slices: each slice's anchors are the other's easy negatives
    assert set(tp.slice_anchors[1]["ix"]) <= set(tp.slice_negatives[0]["ix"])
    for asked in ((1, 64, 64), (3, 8, 5), (2048, 2048, 2048)):
        assert tdata.clamp_counts(tp, *asked) == jdata.clamp_counts(jp, *asked)
    pool = np.arange(7)
    for k in (3, 12):
        np.testing.assert_array_equal(tdata._sample(pool, k, np.random.default_rng(k)),
                                      jdata._sample(pool, k, np.random.default_rng(k)))
    counts = tdata.clamp_counts(tp, 2, 8, 8)
    rt, rj = np.random.default_rng(9), np.random.default_rng(9)
    rows = tdata.construct_contrastive_rows(tp, *counts, rt, balance_by_zs_pred=balance)
    ref = jdata.construct_contrastive_rows(jp, *counts, rj, balance_by_zs_pred=balance)
    np.testing.assert_array_equal(rows, ref)
    assert rows.dtype == ref.dtype and rows.shape[1] == sum(counts)
    assert rt.bit_generator.state == rj.bit_generator.state


def test_contrastive_data_edge_cases():
    # a class with no zero-shot-correct sample: its anchors are skipped with
    # the JAX package's warning, the rest still build
    labels = np.array([0] * 10 + [1] * 10)
    preds = labels.copy()
    preds[10:] = 0  # every class-1 sample is wrong: no class-1 positives
    preds[:2] = 1  # two class-0 anchors with positives
    tp, jp = tdata.prepare_contrastive_points(labels, preds), \
        jdata.prepare_contrastive_points(labels, preds)
    _points_equal(tp, jp)
    out = []
    for mod, pts in ((tdata, tp), (jdata, jp)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out.append(mod.construct_contrastive_rows(pts, 1, 2, 2, np.random.default_rng(0)))
        assert [str(w.message) for w in caught] == [
            "contrastive rows: skipped 10 anchors whose class has no zero-shot-correct "
            "positives (degenerate predictions)"]
    np.testing.assert_array_equal(*out)
    # all-correct predictions: no anchors, the same ValueError text
    labels = np.tile(np.array([0, 1]), 10)
    msgs = []
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match="all correct") as err:
            mod.construct_contrastive_rows(mod.prepare_contrastive_points(labels, labels.copy()),
                                           1, 2, 2, np.random.default_rng(0))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# -------------------------------------------------------------------- epoch --


EPOCHS = {
    "no_head_prenorm_bf1": (None, True, 1),
    "no_head_raw_bf4": (None, False, 4),
    "linear_head_prenorm_bf4": ("linear", True, 4),
    "linear_head_raw_bf1": ("linear", False, 1),
}


@pytest.fixture(scope="module")
def train_data():
    _, table, *_ = make_synthetic_dataset(SyntheticSpec(dim=D))
    train = table.split == 0
    return table.embeddings[train] * 3.0, table.y[train], table.y_pred[train]


def _close(ours, ref, rel=1e-5):
    """Each tensor within ``rel`` of its scale; fc1's bias feeds a BatchNorm,
    so it (and its trace) is held to the scale of fc1's weight."""
    assert set(ours) == set(ref)
    for k, r in ref.items():
        scale = np.abs(ref[k.replace("layers.0.bias", "layers.0.weight")]).max()
        np.testing.assert_allclose(np.asarray(ours[k], np.float64), np.asarray(r, np.float64),
                                   rtol=0, atol=rel * float(scale), err_msg=k)


@pytest.mark.parametrize("case", sorted(EPOCHS))
def test_contrastive_epoch_matches_jax(train_data, case):
    ca_head, pre_norm, bf = EPOCHS[case]
    emb, labels, preds = train_data
    pts = tdata.prepare_contrastive_points(labels, preds)
    a, p, n = tdata.clamp_counts(pts, 2, 8, 8)
    rows = tdata.construct_contrastive_rows(pts, a, p, n, np.random.default_rng(5))
    nb = len(rows) // bf
    rows = rows[: nb * bf].reshape(nb, bf, -1)
    lrs = np.linspace(0.05, 0.5, nb).astype(np.float32)
    enc, variables = _jax_encoder_vars(ca_head, seed=7)
    jstate = jsteps.init_train_state(variables["params"], variables["batch_stats"])
    kw = dict(num_anchor=a, num_positive=p, num_negative=n, temperature=0.1,
              contrastive_weight=0.1, ca_pre_norm=pre_norm, momentum=0.9, weight_decay=5e-5)
    jstate, jlosses_ = jcontrastive.train_contrastive_epoch(
        enc, jstate, jnp.asarray(emb), jnp.asarray(rows), jnp.asarray(lrs),
        jsteps.ones_mask(jstate.params), **kw)
    jstate = jax.device_get(jstate)

    module = tadapter.CAEncoder(D, HIDDEN, ca_head, 8)
    module.load_state_dict(_encoder_sd(variables))
    state = tsteps.init_train_state(module)
    state, losses = tcontrastive.train_contrastive_epoch(
        state, torch.from_numpy(emb), torch.from_numpy(rows), lrs,
        tsteps.ones_mask(state.params), **kw)
    ref = {k: v.numpy() for k, v in _encoder_sd(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}).items()
        if not k.endswith("num_batches_tracked")}
    ours = {k: v.detach().numpy() for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    _close(ours, ref)
    ref_trace = {k: v for k, v in {k: v.numpy() for k, v in _encoder_sd(
        {"params": jstate.trace, "batch_stats": jstate.batch_stats}).items()}.items()
        if k in state.trace}
    _close({k: v.numpy() for k, v in state.trace.items()}, ref_trace)
    assert losses.shape == (nb,)
    np.testing.assert_allclose(np.mean(losses.numpy()), np.mean(np.asarray(jlosses_)),
                               rtol=1e-5)


# --------------------------------------------------------------- whole runs --


BASE = dict(dataset="waterbirds", input_dim=D, adapter_feat_dim=HIDDEN, batch_size=128,
            learning_rate=0.5, lr_decay_epochs=(100,), random_seed=42, epochs=4,
            tl_method="contrastive_adapter", num_positive=8, num_negative=8, batch_factor=2)

RUNS = {
    "full_ce_epoch": dict(ca_ce_update=-1),
    "ce_capped_at_one_batch": dict(ca_ce_update=1),
    "pure_supcon": dict(ca_ce_update=0),
    "linear_head": dict(ca_head="linear"),
}


def _splits(meta):
    return {name: meta.take(np.where(meta.split == sid)[0])
            for name, sid in (("train", 0), ("val", 1), ("test", 2))}


@pytest.fixture(scope="module")
def bundles():
    meta, table, tc, tg, ts = jax_synthetic(JaxSpec())
    jb = jloop.bundle_from_embedding_table(table, _splits(meta), tc, ts, tg)
    meta, table, tc, tg, ts = make_synthetic_dataset(SyntheticSpec())
    tb = tloop.bundle_from_embedding_table(table, _splits(meta), tc, ts, tg, device="cpu")
    assert (tb.train.y != tb.train.y_pred).sum() > 0  # zero-shot mistakes: anchors exist
    return jb, tb


def jax_contrastive_init(cfg):
    """The JAX loop's initial draws for the contrastive method, rebuilt
    (loop.py:375-377, :404-414): the classifier from the second half of the
    first split, the head from the second half of the next."""
    key = jax.random.PRNGKey(cfg.random_seed)
    key, init_key = jax.random.split(key)
    params, stats = jloop._init_variables(jloop.make_classifier(cfg), cfg.input_dim, init_key,
                                          cfg.n_cls)
    init = {"init_sd": classifier_state_dict_from_jax_variables(
        {"params": params, "batch_stats": stats})}
    if cfg.ca_head is not None:
        key, head_key = jax.random.split(key)
        enc = jadapter.CAEncoder(hidden_dim=cfg.adapter_feat_dim, ca_head=cfg.ca_head,
                                 ca_feat_dim=cfg.ca_feat_dim)
        head = enc.init(head_key, jnp.zeros((2, cfg.input_dim), jnp.float32), train=True)
        init["ca_head_sd"] = ca_head_state_dict_from_jax(head["params"]["head"])
    return init


@pytest.mark.parametrize("run", sorted(RUNS))
def test_contrastive_run_matches_jax(bundles, run):
    jb, tb = bundles
    flags = {**BASE, **RUNS[run]}
    jcfg = JaxConfig(**flags)
    best_ref, zs_ref, hist_ref = jloop.train_all_epochs(jcfg, jb, verbose=False)
    best, zs, hist = tloop.train_all_epochs(TrainConfig(**flags), tb, verbose=False,
                                            init=jax_contrastive_init(jcfg), device="cpu")
    for split in ("train", "val", "test"):
        assert hist[split] == hist_ref[split], split
    assert best == best_ref and zs == zs_ref
    assert len(hist["cl_loss"]) == BASE["epochs"]
    np.testing.assert_allclose(hist["cl_loss"], hist_ref["cl_loss"], rtol=1e-5)


def test_contrastive_resume_is_bit_exact(tmp_path, bundles):
    _, tb = bundles
    cfg = TrainConfig(**{**BASE, **RUNS["linear_head"]})
    full_dir, part_dir = str(tmp_path / "full"), str(tmp_path / "part")
    full = tloop.train_all_epochs(cfg, tb, verbose=False, checkpoint_dir=full_dir,
                                  checkpoint_every=100, device="cpu")
    tloop.train_all_epochs(cfg.replace(epochs=2), tb, verbose=False, checkpoint_dir=part_dir,
                           checkpoint_every=1, device="cpu")
    resumed = tloop.train_all_epochs(cfg, tb, verbose=False, checkpoint_dir=part_dir,
                                     resume=True, checkpoint_every=100, device="cpu")
    assert resumed == full and len(full[2]["cl_loss"]) == cfg.epochs
    _, a, meta_a = tckpt.load_checkpoint(tckpt.latest_checkpoint(full_dir))
    _, b, meta_b = tckpt.load_checkpoint(tckpt.latest_checkpoint(part_dir))
    assert meta_a["history"] == meta_b["history"] and meta_a["rng_state"] == meta_b["rng_state"]
    assert set(a) == set(b) == {"state", "head_state", "best_state", "torch_rng_state"}
    assert set(a["head_state"]["params"]) == {"head.weight", "head.bias"}

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
    assert la["head_state/trace/head.weight/"].abs().max() > 0
