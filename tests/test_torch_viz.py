"""``viz/`` of the port against the JAX package's on the CPU:
``umap_lite`` (its numpy k-nearest-neighbour search equals sklearn's; with
sklearn's neighbours fed in, the embedding is the JAX module's to the bit;
the same seed gives the same embedding; the quality pin of the JAX suite),
``analysis`` (group statistics, projections, the joint projection and the
anchors equal the JAX module's; ``adapted_embeddings`` runs the port's
adapter in eval mode within 1e-5 of the JAX adapter) and ``plots`` (the
figures render; the stats table equals the JAX one).  sklearn and
matplotlib are imported by the tests that need them (``importorskip``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu.data.synthetic import SyntheticSpec, make_synthetic_dataset
from debiasing_multi_modal_tpu.viz import analysis as janalysis
from debiasing_multi_modal_tpu.viz import umap_lite as jumap
from debiasing_multi_modal_tpu_torch.viz import analysis
from debiasing_multi_modal_tpu_torch.viz import umap_lite


@pytest.fixture(scope="module")
def synth():
    meta, table, tc, tg, ts = make_synthetic_dataset(
        SyntheticSpec(n_train=128, n_val=64, n_test=64, dim=16))
    return table, tc


def _splits(table, names=("train", "val", "test")):
    embs, grps, labels = {}, {}, {}
    for name in names:
        idx = np.where(table.split == ("train", "val", "test").index(name))[0]
        embs[name] = table.embeddings[idx]
        grps[name] = table.group[idx]
        labels[name] = {"group": table.group[idx], "target": table.y[idx],
                        "spurious": table.place[idx], "prediction": table.y_pred[idx]}
    return embs, grps, labels


def test_knn_equals_sklearn():
    neighbors = pytest.importorskip("sklearn.neighbors")
    rng = np.random.default_rng(3)
    for x in (rng.standard_normal((80, 16)), rng.standard_normal((700, 64))):
        d, i = umap_lite._knn(x, 16)
        d_ref, i_ref = neighbors.NearestNeighbors(n_neighbors=16).fit(x).kneighbors(x)
        np.testing.assert_array_equal(i, i_ref)
        # the self distance is exactly 0 here, a rounding residue in sklearn's
        np.testing.assert_allclose(d[:, 1:], d_ref[:, 1:], rtol=1e-12, atol=1e-12)


def test_umap_lite_with_sklearn_neighbours_is_the_jax_embedding(monkeypatch):
    """Everything past the neighbour search is the JAX module's numpy, so
    with sklearn's neighbours the embedding is equal to the bit.  (With its
    own exact distances, which differ from sklearn's by ~1e-15, the 200
    epochs of SGD land elsewhere: UMAP is chaotic in its inputs.)"""
    neighbors = pytest.importorskip("sklearn.neighbors")

    def sklearn_knn(x, k):
        return neighbors.NearestNeighbors(n_neighbors=k).fit(x).kneighbors(x)

    monkeypatch.setattr(umap_lite, "_knn", sklearn_knn)
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal((60, 16)) + 6.0 * np.eye(16)[c] for c in range(3)])
    for kw in (dict(n_epochs=30), dict()):
        got = umap_lite.UMAP(n_components=2, random_state=42, **kw).fit_transform(x)
        want = jumap.UMAP(n_components=2, random_state=42, **kw).fit_transform(x)
        np.testing.assert_array_equal(got, want)


def test_umap_lite_deterministic_per_seed():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((80, 16))
    a = umap_lite.UMAP(n_components=2, random_state=42, n_epochs=30).fit_transform(x)
    b = umap_lite.UMAP(n_components=2, random_state=42, n_epochs=30).fit_transform(x)
    np.testing.assert_array_equal(a, b)
    c = umap_lite.UMAP(n_components=2, random_state=7, n_epochs=30).fit_transform(x)
    assert np.abs(a - c).max() > 0


def test_umap_lite_trustworthiness_and_continuity():
    """The JAX suite's quality pin, on the port's UMAP (same thresholds)."""
    manifold = pytest.importorskip("sklearn.manifold")
    rng = np.random.default_rng(0)
    n_per, d = 100, 64
    labels = np.repeat(np.arange(4), n_per)
    for spread in (4.0, 2.0):
        centers = rng.standard_normal((4, d)) * spread
        x = np.concatenate([c + rng.standard_normal((n_per, d)) for c in centers])
        emb = umap_lite.UMAP(n_components=2, n_neighbors=15, random_state=42).fit_transform(x)
        assert manifold.trustworthiness(x, emb, n_neighbors=15) >= 0.88
        assert manifold.trustworthiness(emb, x, n_neighbors=15) >= 0.89
        _, idx = umap_lite._knn(emb.astype(np.float64), 11)
        assert (labels[idx[:, 1:]] == labels[:, None]).mean() >= 0.97


def test_group_statistics_and_anchors_equal_jax(synth):
    table, tc = synth
    got = analysis.group_stats(table.embeddings, table.group)
    assert got == janalysis.group_stats(table.embeddings, table.group)
    assert analysis.mean_pairwise_distance(table.embeddings) == \
        janalysis.mean_pairwise_distance(table.embeddings)
    np.testing.assert_array_equal(analysis.group_mean_vectors(table.embeddings, table.group),
                                  janalysis.group_mean_vectors(table.embeddings, table.group))
    assert analysis.nearest_sample(table.embeddings, table.embeddings[7]) == 7
    np.testing.assert_array_equal(analysis.nearest_averaged(table.embeddings, tc[:, 0]),
                                  janalysis.nearest_averaged(table.embeddings, tc[:, 0]))


@pytest.mark.parametrize("method", ["pca", "mds", "umap"])
def test_projections_equal_jax(synth, method):
    if method != "umap":
        pytest.importorskip("sklearn")
    table, _ = synth
    emb = table.embeddings[:50]
    got = analysis.project_2d(emb, method=method)
    assert got.shape == (50, 2)
    if method != "umap":  # the umap fallbacks' neighbours differ in rounding (above)
        np.testing.assert_array_equal(got, janalysis.project_2d(emb, method=method))
    with pytest.raises(ValueError, match="unknown projection method"):
        analysis.project_2d(emb, method="nope")


def test_joint_projection_equals_jax(synth):
    pytest.importorskip("sklearn")
    table, tc = synth
    embs, grps, _ = _splits(table)
    got = analysis.joint_projection(embs, split_groups=grps, text_embeddings=tc.T,
                                    method="pca", seed=42)
    want = janalysis.joint_projection(embs, split_groups=grps, text_embeddings=tc.T,
                                      method="pca", seed=42)
    for name in embs:
        np.testing.assert_array_equal(got["splits"][name], want["splits"][name])
        np.testing.assert_array_equal(got["group_means"][name], want["group_means"][name])
    np.testing.assert_array_equal(got["text"], want["text"])


def test_adapted_embeddings_match_the_jax_adapter(synth):
    """The JAX ``AdapterMLP``'s variables (its BatchNorm statistics drawn)
    in the port's adapter, eval mode: within 1e-5 of the JAX module."""
    from debiasing_multi_modal_tpu.models.adapter import AdapterMLP as JaxAdapter
    from debiasing_multi_modal_tpu_torch.models.adapter import AdapterMLP
    from debiasing_multi_modal_tpu_torch.weights.convert import _adapter_mlp_to_sd

    table, _ = synth
    jmodule = JaxAdapter(hidden_dim=8)
    variables = jmodule.init(jax.random.PRNGKey(0), jnp.asarray(table.embeddings[:2]),
                             train=True)
    rng = np.random.default_rng(4)
    stats = jax.tree.map(lambda a: jnp.asarray(rng.uniform(0.2, 1.5, a.shape), a.dtype),
                         variables["batch_stats"])
    want = janalysis.adapted_embeddings(jmodule, variables["params"], stats, table.embeddings,
                                        batch_size=64)
    sd = {}
    _adapter_mlp_to_sd(variables["params"], stats, "", sd)
    module = AdapterMLP(16, 8).train()
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    got = analysis.adapted_embeddings(module, None, None, table.embeddings, batch_size=64)
    assert module.training  # the caller's mode is restored
    assert got.shape == table.embeddings.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the same from state-dict entries handed in, on a module with others
    params = {k: v for k, v in sd.items() if not k.endswith(("running_mean", "running_var",
                                                             "num_batches_tracked"))}
    buffers = {k: v for k, v in sd.items() if k not in params}
    other = AdapterMLP(16, 8, generator=torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(
        analysis.adapted_embeddings(other, params, buffers, table.embeddings, batch_size=64), got)


def test_plots_render(tmp_path, synth):
    pytest.importorskip("matplotlib")
    pytest.importorskip("sklearn")
    import matplotlib.pyplot as plt

    from debiasing_multi_modal_tpu.viz import plots as jplots
    from debiasing_multi_modal_tpu_torch.viz import plots

    table, tc = synth
    embs, _, labels = _splits(table, ("train", "val"))
    out = str(tmp_path / "splits.png")
    fig = plots.plot_splits(embs, labels, dataset="waterbirds", color_by="group",
                            method="pca", text_embeddings=tc.T,
                            text_names=["landbird", "waterbird"], out_path=out)
    assert os.path.isfile(out) and os.path.getsize(out) > 1000
    plt.close(fig)
    embs, grps, labels = _splits(table)
    accs = {"mean_acc": 0.9, "worst_acc": 0.5, "acc_0_0": 1.0, "acc_0_1": 0.5,
            "acc_1_0": 0.8, "acc_1_1": 0.9}
    tables = {n: plots.split_stats_table(embs[n], grps[n], group_accs=accs) for n in embs}
    for n in embs:
        assert tables[n] == jplots.split_stats_table(embs[n], grps[n], group_accs=accs)
    for dims in (2, 3):
        out = str(tmp_path / f"joint{dims}d.png")
        fig, proj = plots.plot_splits_joint(
            embs, labels, dataset="waterbirds", color_by="group", method="pca",
            text_embeddings=tc.T,
            text_names=["a photo of a landbird.", "a photo of a waterbird."],
            stats_tables=tables if dims == 2 else None, out_path=out, n_components=dims)
        assert proj["splits"]["train"].shape[1] == dims
        assert os.path.isfile(out) and os.path.getsize(out) > 1000
        plt.close(fig)
