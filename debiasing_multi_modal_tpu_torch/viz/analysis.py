"""Embedding-space analysis (port of ``viz/analysis.py``; reference
``demo/visualizer.py`` C15).  Everything but ``adapted_embeddings`` is the
JAX module's numpy, copied.

- ``adapted_embeddings``: run cached CLIP embeddings through a trained
  adapter (the VisHandler "extract activations" path, visualizer.py:100-134):
  the port's adapter module in eval mode, batch by batch.
- ``group_stats`` / ``group_mean_vectors``: per-group mean vector, mean-vector
  norm, mean pairwise distance, with the full-dataset row first
  (``GetGroupWiseStatEbd``, visualizer.py:657-690).
- ``project`` / ``project_2d``: low-dim projection for plotting — umap-learn
  when installed (the reference default, seeded), else the vendored
  ``viz.umap_lite`` implementation; sklearn MDS (the reference's ``plot_mds``
  alternative) and PCA selectable, sklearn imported only then.
- ``joint_projection``: the ``VisRepAll`` semantics (visualizer.py:182-262 +
  plot_umap_all:411-505): ONE projection fitted over train+val+test jointly,
  with nearest-image-averaged text-prompt anchors and per-split
  [full + group] centroid rows appended to the pool before fitting, then
  sliced back out — so every panel lives in the same reduced space.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def adapted_embeddings(
    module,
    params,
    batch_stats,
    embeddings: np.ndarray,
    batch_size: int = 1024,
    device=None,
) -> np.ndarray:
    """Adapter-transformed features: the port's adapter ``module`` in eval
    mode (running BatchNorm statistics), batch by batch on ``device`` (the
    module's own unless given), at full f32 as Stage B runs.  ``params`` /
    ``batch_stats`` are state-dict entries that replace the module's
    parameters / buffers (None keeps the module's own)."""
    import torch
    from torch.func import functional_call

    from debiasing_multi_modal_tpu_torch.utils.platform import full_f32

    dev = next(module.parameters()).device if device is None else torch.device(device)
    state = {}
    for part in (params, batch_stats):
        state.update({k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in (part or {}).items()})
    was_training = module.training
    module.eval()
    out = []
    try:
        with torch.no_grad(), full_f32():
            for start in range(0, len(embeddings), batch_size):
                batch = torch.as_tensor(np.asarray(embeddings[start:start + batch_size],
                                                   np.float32)).to(dev)
                res = functional_call(module, state, (batch,)) if state else module(batch)
                out.append(res.float().cpu().numpy())
    finally:
        module.train(was_training)
    return np.concatenate(out, axis=0)


def mean_pairwise_distance(
    embeddings: np.ndarray,
    max_n: int = 512,
    rng: Optional[np.random.Generator] = None,
) -> float:
    """Mean pairwise Euclidean distance, via the Gram-matrix identity
    ||a-b||^2 = |a|^2 + |b|^2 - 2ab (no O(n^2 * D) broadcast temp), with a
    seeded RANDOM subsample for large sets (a prefix would be biased — split
    tables are metadata-ordered, correlated with class/group)."""
    n = len(embeddings)
    if n < 2:
        return 0.0
    if n > max_n:
        rng = rng or np.random.default_rng(0)
        embeddings = embeddings[rng.choice(n, max_n, replace=False)]
        n = max_n
    e = embeddings.astype(np.float64)
    sq = (e ** 2).sum(axis=1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (e @ e.T), 0.0)
    d = np.sqrt(d2)
    return float(d[np.triu_indices(n, 1)].mean())


def group_stats(embeddings: np.ndarray, groups: np.ndarray, n_groups: int = 4,
                max_pairwise: int = 512, seed: int = 0) -> Dict[int, Dict[str, float]]:
    """Per-group {mean_norm, mean_pairwise_dist, count} (visualizer.py:657-690).

    Pairwise distance is subsampled for large groups (the reference computes
    the full quadratic matrix; statistically identical)."""
    rng = np.random.default_rng(seed)
    stats: Dict[int, Dict[str, float]] = {}
    for g in range(n_groups):
        idx = np.where(groups == g)[0]
        if len(idx) == 0:
            stats[g] = {"count": 0, "mean_norm": float("nan"), "mean_pairwise_dist": float("nan")}
            continue
        sub = embeddings[idx]
        stats[g] = {
            "count": int(len(idx)),
            "mean_norm": float(np.linalg.norm(sub.mean(axis=0))),
            "mean_pairwise_dist": mean_pairwise_distance(sub, max_pairwise, rng),
        }
    return stats


def project(
    embeddings: np.ndarray,
    method: str = "auto",
    seed: int = 42,
    n_neighbors: int = 15,
    n_components: int = 2,
) -> np.ndarray:
    """[N, D] -> [N, n_components] for plotting."""
    if method == "auto":
        method = "umap"
    if method == "umap":
        try:
            from umap import UMAP  # umap-learn, the reference's projector
        except ImportError:
            from debiasing_multi_modal_tpu_torch.viz.umap_lite import UMAP

        return UMAP(
            n_components=n_components, random_state=seed,
            n_neighbors=min(n_neighbors, max(len(embeddings) - 1, 2)),
        ).fit_transform(embeddings)
    if method == "mds":
        from sklearn.manifold import MDS

        return MDS(
            n_components=n_components, random_state=seed,
            normalized_stress="auto",
        ).fit_transform(embeddings)
    if method == "pca":
        from sklearn.decomposition import PCA

        return PCA(n_components=n_components, random_state=seed).fit_transform(
            embeddings
        )
    raise ValueError(f"unknown projection method {method!r}")


def project_2d(
    embeddings: np.ndarray,
    method: str = "auto",
    seed: int = 42,
    n_neighbors: int = 15,
) -> np.ndarray:
    """[N, D] -> [N, 2] for plotting."""
    return project(embeddings, method, seed, n_neighbors, n_components=2)


def nearest_sample(embeddings: np.ndarray, query: np.ndarray) -> int:
    """Index of the embedding closest to ``query`` (the reference anchors
    text prompts in image space via the nearest image, visualizer.py:19-27)."""
    d = np.linalg.norm(embeddings - query[None, :], axis=1)
    return int(np.argmin(d))


def nearest_averaged(embeddings: np.ndarray, query: np.ndarray, k: int = 10) -> np.ndarray:
    """Mean of the top-k cosine-nearest image embeddings to ``query`` — the
    reference's text-prompt anchoring (find_closest_sample, visualizer.py:
    19-27 + plot_umap_all:446-458: text features are replaced by the average
    of their nearest images before entering the projection pool)."""
    # zero rows happen (ReLU-MLP adapted features can die); 0/0 NaNs would
    # poison the anchor means and thence the whole joint projection
    e = embeddings / np.maximum(
        np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-12
    )
    q = query / max(float(np.linalg.norm(query)), 1e-12)
    sims = e @ q
    top = np.argsort(sims)[::-1][: min(k, len(embeddings))]
    return embeddings[top].mean(axis=0)


def group_mean_vectors(
    embeddings: np.ndarray, groups: np.ndarray, n_groups: int = 4
) -> np.ndarray:
    """[n_groups + 1, D]: the full-dataset mean first, then each group's mean
    (GetGroupWiseStatEbd's mean_vector dict ordering, visualizer.py:666-686)."""
    rows = [embeddings.mean(axis=0)]
    for g in range(n_groups):
        m = groups == g
        rows.append(embeddings[m].mean(axis=0) if m.any() else rows[0])
    return np.stack(rows)


def joint_projection(
    split_embeddings: Dict[str, np.ndarray],
    split_groups: Optional[Dict[str, np.ndarray]] = None,
    text_embeddings: Optional[np.ndarray] = None,  # [C, D]
    method: str = "auto",
    seed: int = 42,
    num_nn_text: int = 10,
    n_components: int = 2,
    n_groups: int = 4,
):
    """Fit ONE projection over all splits jointly (VisRepAll semantics).

    The pool is [all split rows | nearest-averaged text anchors | per-split
    (full + group) centroid rows]; one fit_transform; coordinates sliced back
    out (plot_umap_all:428-505).  Returns a dict with:

    - ``splits``: {name: [N_s, d] coords},
    - ``text``: [C, d] coords or None,
    - ``group_means``: {name: [n_groups+1, d] coords} (row 0 = full mean)
      or None when ``split_groups`` is not given.
    """
    names = list(split_embeddings)
    blocks = [np.asarray(split_embeddings[n], np.float32) for n in names]
    pool = np.concatenate(blocks, axis=0)
    sizes = [len(b) for b in blocks]

    extra = []
    n_text = 0
    if text_embeddings is not None:
        anchors = np.stack(
            [nearest_averaged(pool, t, num_nn_text) for t in text_embeddings]
        )
        extra.append(anchors)
        n_text = len(anchors)
    if split_groups is not None:
        for n, b in zip(names, blocks):
            extra.append(group_mean_vectors(b, np.asarray(split_groups[n]), n_groups))
    full = np.concatenate([pool] + extra, axis=0) if extra else pool

    coords = project(full, method=method, seed=seed, n_components=n_components)

    out = {"splits": {}, "text": None, "group_means": None}
    off = 0
    for n, s in zip(names, sizes):
        out["splits"][n] = coords[off : off + s]
        off += s
    if n_text:
        out["text"] = coords[off : off + n_text]
        off += n_text
    if split_groups is not None:
        out["group_means"] = {}
        for n in names:
            out["group_means"][n] = coords[off : off + n_groups + 1]
            off += n_groups + 1
    return out
