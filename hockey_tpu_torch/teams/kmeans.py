"""Two-cluster k-means for the segmentation team classifier, in numpy.

Replaces `sklearn.cluster.KMeans(n_clusters=2, random_state=42, n_init=10)`
of hockey_tpu/teams/segmentation.py:23,83 (the GPU machine has no
scikit-learn): greedy k-means++ seeding, Lloyd iterations to a relative
tolerance of the data's variance, the best of `n_init` seedings by
inertia, seeded by `np.random.default_rng(random_state)`. It cannot
reproduce scikit-learn's random stream, so it is held to the same
partition, not to the same draws.
"""

from __future__ import annotations

import numpy as np


def _sq_dist(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """(n, k) squared Euclidean distances."""
    return ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)


class KMeans:
    """fit / fit_predict / predict with `cluster_centers_`, `labels_` and
    `inertia_`, in float64; `cluster_centers_` may be replaced after the
    fit (the classifier reorders the clusters)."""

    def __init__(self, n_clusters: int = 2, random_state: int = 42,
                 n_init: int = 10, max_iter: int = 300, tol: float = 1e-4):
        self.n_clusters, self.random_state = n_clusters, random_state
        self.n_init, self.max_iter, self.tol = n_init, max_iter, tol
        self.cluster_centers_ = None
        self.labels_ = None
        self.inertia_ = None

    def _seed(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Greedy k-means++: each new centre is the best of 2 + log(k)
        candidates drawn in proportion to the squared distance."""
        n, k = len(x), self.n_clusters
        trials = 2 + int(np.log(k))
        centers = [x[rng.integers(n)]]
        closest = _sq_dist(x, np.asarray(centers))[:, 0]
        for _ in range(1, k):
            total = closest.sum()
            if total <= 0:  # every point sits on a centre
                cand = rng.integers(n, size=trials)
            else:
                cand = np.searchsorted(np.cumsum(closest),
                                       rng.uniform(size=trials) * total)
                cand = np.minimum(cand, n - 1)
            pot = np.minimum(closest[None], _sq_dist(x, x[cand]).T)
            best = int(np.argmin(pot.sum(1)))
            centers.append(x[cand[best]])
            closest = pot[best]
        return np.asarray(centers)

    def _lloyd(self, x: np.ndarray, centers: np.ndarray, tol: float):
        for _ in range(self.max_iter):
            labels = np.argmin(_sq_dist(x, centers), axis=1)
            new = centers.copy()
            for c in range(self.n_clusters):
                if (labels == c).any():
                    new[c] = x[labels == c].mean(0)
            shift = ((new - centers) ** 2).sum()
            centers = new
            if shift <= tol:
                break
        d = _sq_dist(x, centers)
        labels = np.argmin(d, axis=1)
        return centers, labels, float(d[np.arange(len(x)), labels].sum())

    def fit(self, x) -> "KMeans":
        x = np.asarray(x, np.float64)
        if len(x) < self.n_clusters:
            raise ValueError(f"n_samples={len(x)} should be >= "
                             f"n_clusters={self.n_clusters}")
        tol = self.tol * float(np.mean(np.var(x, axis=0)))
        rng = np.random.default_rng(self.random_state)
        best = None
        for _ in range(self.n_init):
            run = self._lloyd(x, self._seed(x, rng), tol)
            if best is None or run[2] < best[2]:
                best = run
        self.cluster_centers_, self.labels_, self.inertia_ = best
        return self

    def fit_predict(self, x) -> np.ndarray:
        return self.fit(x).labels_

    def predict(self, x) -> np.ndarray:
        """Index of the nearest centre of each row of x."""
        x = np.asarray(x, np.float64).reshape(-1, self.cluster_centers_.shape[1])
        return np.argmin(_sq_dist(x, np.asarray(self.cluster_centers_)), axis=1)
