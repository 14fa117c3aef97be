"""Minimal UMAP-compatible embedding (fallback when umap-learn is absent);
a copy of the JAX package's ``viz/umap_lite.py`` whose k-nearest-neighbour
search is numpy (exact Euclidean distances, ties by index) instead of
sklearn's, so it runs where sklearn is not installed.

The reference's visualizer projects with ``umap.UMAP(random_state=42,
n_components=d).fit_transform`` (demo/visualizer.py:478-481).  This module
implements the same algorithmic skeleton from scratch on numpy and scipy:

1. kNN graph with per-point adaptive bandwidth (smooth-kNN calibration to
   ``log2(k)`` total fuzzy membership — UMAP §3.1's binary search),
2. symmetrization by fuzzy union ``P + P' - P*P'``,
3. spectral initialization from the symmetric normalized graph Laplacian,
4. stochastic gradient refinement with UMAP's attractive/repulsive forces
   under the standard (a, b) curve for min_dist=0.1.

It exposes the same surface (``UMAP(n_components, n_neighbors, random_state,
n_epochs).fit_transform``) so ``viz.analysis.project_2d`` can dispatch to it
transparently.  It is a faithful-small, not bit-identical, UMAP: cluster
structure and neighbor preservation match; exact coordinates do not.  The
same seed gives the same embedding.
"""

from __future__ import annotations

import numpy as np

# Curve parameters fitted for min_dist=0.1, spread=1.0 (umap-learn defaults).
_A, _B = 1.576943, 0.895061


def _smooth_knn(dists: np.ndarray, n_iter: int = 32) -> np.ndarray:
    """Per-row bandwidth sigma s.t. sum(exp(-(d - rho)/sigma)) = log2(k)."""
    k = dists.shape[1]
    target = np.log2(k)
    rho = dists[:, 0]
    adj = dists - rho[:, None]
    lo = np.zeros(len(dists))
    hi = np.full(len(dists), np.inf)
    sigma = np.ones(len(dists))
    for _ in range(n_iter):
        val = np.exp(-np.maximum(adj, 0.0) / sigma[:, None]).sum(axis=1)
        too_big = val > target
        hi = np.where(too_big, sigma, hi)
        lo = np.where(too_big, lo, sigma)
        sigma = np.where(np.isinf(hi), sigma * 2.0, (lo + hi) / 2.0)
    return np.maximum(sigma, 1e-12)


def _knn(X: np.ndarray, k: int, rows: int = 256):
    """The ``k`` nearest rows of ``X`` to each row (itself first), as
    ``(distances, indices)`` sorted by distance, then index.  Candidates by
    the Gram identity, distances recomputed exactly from the differences."""
    n = len(X)
    sq = (X * X).sum(axis=1)
    extra = min(n, k + 8)  # margin for the Gram identity's rounding
    dists = np.empty((n, k))
    idx = np.empty((n, k), np.int64)
    for lo in range(0, n, rows):
        block = X[lo:lo + rows]
        d2 = sq[lo:lo + rows, None] + sq[None, :] - 2.0 * (block @ X.T)
        cand = np.argpartition(d2, extra - 1, axis=1)[:, :extra] if extra < n else \
            np.broadcast_to(np.arange(n), (len(block), n))
        exact = np.sqrt(((X[cand] - block[:, None, :]) ** 2).sum(axis=2))
        order = np.lexsort((cand, exact), axis=1)[:, :k]
        dists[lo:lo + rows] = np.take_along_axis(exact, order, axis=1)
        idx[lo:lo + rows] = np.take_along_axis(cand, order, axis=1)
    return dists, idx


class UMAP:
    def __init__(
        self,
        n_components: int = 2,
        n_neighbors: int = 15,
        random_state: int = 42,
        n_epochs: int = 200,
        learning_rate: float = 1.0,
        negative_sample_rate: int = 5,
    ):
        self.n_components = n_components
        self.n_neighbors = n_neighbors
        self.random_state = random_state
        self.n_epochs = n_epochs
        self.learning_rate = learning_rate
        self.negative_sample_rate = negative_sample_rate

    # -------------------------------------------------------------- graph --
    def _fuzzy_graph(self, X: np.ndarray):
        from scipy.sparse import coo_matrix

        n = len(X)
        k = min(self.n_neighbors, n - 1)
        dists, idx = _knn(X, k + 1)
        dists, idx = dists[:, 1:], idx[:, 1:]  # drop self
        sigma = _smooth_knn(dists)
        rho = dists[:, 0]
        w = np.exp(-np.maximum(dists - rho[:, None], 0.0) / sigma[:, None])
        rows = np.repeat(np.arange(n), k)
        P = coo_matrix((w.ravel(), (rows, idx.ravel())), shape=(n, n)).tocsr()
        PT = P.T.tocsr()
        return P + PT - P.multiply(PT)  # fuzzy union

    def _spectral_init(self, G) -> np.ndarray:
        from scipy.sparse import diags
        from scipy.sparse.linalg import eigsh

        n = G.shape[0]
        deg = np.asarray(G.sum(axis=1)).ravel()
        dinv = diags(1.0 / np.sqrt(np.maximum(deg, 1e-12)))
        L = diags(np.ones(n)) - dinv @ G @ dinv
        try:
            # deterministic ARPACK start vector: eigsh otherwise seeds from
            # numpy's global RNG and the layout changes call to call
            v0 = np.random.default_rng(self.random_state).standard_normal(n)
            _, vecs = eigsh(L, k=self.n_components + 1, sigma=0.0, which="LM", v0=v0)
            init = vecs[:, 1 : self.n_components + 1]
            # fix the eigenvector sign ambiguity
            signs = np.sign(init[np.abs(init).argmax(axis=0), np.arange(init.shape[1])])
            init = init * np.where(signs == 0, 1.0, signs)
        except Exception:  # eigensolver failure on degenerate graphs
            rng = np.random.default_rng(self.random_state)
            init = rng.standard_normal((n, self.n_components))
        scale = np.abs(init).max() or 1.0
        return (init / scale * 10.0).astype(np.float64)

    # ---------------------------------------------------------------- fit --
    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        n = len(X)
        if n <= self.n_components + 2:
            # degenerate: center and truncate
            c = X - X.mean(axis=0)
            return c[:, : self.n_components].astype(np.float32)
        G = self._fuzzy_graph(X).tocoo()
        emb = self._spectral_init(G.tocsr())

        rng = np.random.default_rng(self.random_state)
        head, tail, w = G.row, G.col, G.data
        w = w / w.max()
        # UMAP's epoch scheduling: edge e is applied every 1/w[e] epochs
        epochs_per_sample = np.where(w > 0, 1.0 / np.maximum(w, 1e-12), np.inf)
        next_epoch = epochs_per_sample.copy()

        a, b, d = _A, _B, self.n_components
        for epoch in range(1, self.n_epochs + 1):
            # (epoch-1)/n keeps the LAST epoch's alpha nonzero (umap-learn
            # counts epochs from 0 — an alpha=0 epoch is pure wasted work)
            alpha = self.learning_rate * (1.0 - (epoch - 1.0) / self.n_epochs)
            active = next_epoch <= epoch
            if not active.any():
                continue
            hi, ti = head[active], tail[active]
            diff = emb[hi] - emb[ti]
            # coincident points (duplicate pool rows happen: an empty group's
            # mean vector equals the full mean) would hit 0**(b-1) = inf and
            # NaN the whole embedding; umap-learn guards dist2 == 0 the same
            dist2 = np.maximum((diff ** 2).sum(axis=1), 1e-12)
            # attractive gradient coefficient
            grad_coeff = (-2.0 * a * b * dist2 ** (b - 1.0)) / (
                a * dist2 ** b + 1.0
            )
            g = np.clip(grad_coeff[:, None] * diff, -4.0, 4.0)
            np.add.at(emb, hi, alpha * g)
            np.add.at(emb, ti, -alpha * g)
            # negative samples
            for _ in range(self.negative_sample_rate):
                neg = rng.integers(0, n, size=len(hi))
                diff = emb[hi] - emb[neg]
                dist2 = np.maximum((diff ** 2).sum(axis=1), 1e-12)
                rep = (2.0 * b) / ((0.001 + dist2) * (a * dist2 ** b + 1.0))
                g = np.clip(rep[:, None] * diff, -4.0, 4.0)
                np.add.at(emb, hi, alpha * g)
            next_epoch[active] += epochs_per_sample[active]
        return emb.astype(np.float32)
