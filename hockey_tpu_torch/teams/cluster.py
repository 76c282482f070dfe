"""The port's own versions of what the JAX team classifiers take from
scikit-learn, on numpy and scipy (the GPU machine has no scikit-learn):

- `StandardScaler` (hybrid, robust): scikit-learn's arithmetic, the mean
  and variance accumulated in float64, constant features scaled by 1;
- `PCA` (robust, hockey_tpu robust.py:226-228): scikit-learn 1.9's
  'auto' solver policy, the full SVD, the covariance eigendecomposition,
  and its randomized SVD (Halko et al.) drawn from
  `np.random.RandomState(random_state)` as scikit-learn draws it, with the
  same LU power iterations and sign convention;
- `SpectralClustering(affinity="rbf")` (hybrid, hockey_tpu
  hybrid.py:87-91): the rbf affinity, the symmetric normalised Laplacian
  (its diagonal ignored), its eigenvectors of the smallest eigenvalues
  scaled by 1 / sqrt(degree), then k-means (`teams/kmeans.py`, seeded by
  `random_state`). A dense `eigh` takes the place of ARPACK, and the
  k-means cannot reproduce scikit-learn's random stream: the same
  partition, up to the labels' order, not the same draws;
- `HDBSCAN(min_cluster_size, min_samples, cluster_selection_method="eom")`
  (robust, hockey_tpu robust.py:230-242): core distances, Prim's minimum
  spanning tree of the mutual reachability graph, the single-linkage tree,
  the condensed tree, excess-of-mass selection, `labels_` and
  `probabilities_`, following scikit-learn's `_hdbscan` step by step
  (dense distances instead of a KD-tree).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .kmeans import KMeans


def _float_array(x) -> np.ndarray:
    x = np.asarray(x)
    return x if x.dtype in (np.float32, np.float64) else x.astype(np.float64)


class StandardScaler:
    """fit / transform / fit_transform with `mean_`, `var_`, `scale_`
    (float64), as scikit-learn's; a float32 input stays float32."""

    def __init__(self):
        self.mean_ = self.var_ = self.scale_ = None

    def fit(self, x) -> "StandardScaler":
        x = _float_array(x)
        n = x.shape[0]
        total = x.sum(axis=0, dtype=np.float64)
        temp = x - total / n
        correction = temp.sum(axis=0)
        var = ((temp ** 2).sum(axis=0) - correction ** 2 / n) / n
        mean = total / n
        eps = np.finfo(np.float64).eps
        constant = var <= n * eps * var + (n * mean * eps) ** 2
        scale = np.sqrt(var)
        scale[constant] = 1.0
        self.mean_, self.var_, self.scale_ = mean, var, scale
        return self

    def transform(self, x) -> np.ndarray:
        out = _float_array(x).copy()
        out -= self.mean_
        out /= self.scale_
        return out

    def fit_transform(self, x) -> np.ndarray:
        return self.fit(x).transform(x)


def _svd_flip_v(u: Optional[np.ndarray], vt: np.ndarray):
    """scikit-learn's `svd_flip(u, vt, u_based_decision=False)`: each
    row of vt made positive at its largest magnitude."""
    signs = np.sign(vt[np.arange(vt.shape[0]), np.argmax(np.abs(vt), axis=1)])
    if u is not None:
        u = u * signs[None, :]
    return u, vt * signs[:, None]


class PCA:
    """fit_transform / transform with `mean_` and `components_`, for an
    integer `n_components`, as scikit-learn's PCA(n_components,
    random_state) with svd_solver 'auto'."""

    def __init__(self, n_components: int, random_state: Optional[int] = None):
        self.n_components = n_components
        self.random_state = random_state
        self.mean_ = self.components_ = None
        self.solver = None

    def _solver(self, n: int, f: int) -> str:
        k = self.n_components
        if f <= 1000 and n >= 10 * f:
            return "covariance_eigh"
        if max(n, f) <= 500:
            return "full"
        if 1 <= k < 0.8 * min(n, f):
            return "randomized"
        return "full"

    def _randomized(self, xc: np.ndarray):
        """scikit-learn's `_randomized_svd(xc, k, n_oversamples=10,
        n_iter='auto', power_iteration_normalizer='auto')` -> (U, S, Vt)."""
        from scipy import linalg

        k = self.n_components
        n, f = xc.shape
        n_iter = 7 if k < 0.1 * min(n, f) else 4
        transpose = n < f
        m = xc.T if transpose else xc
        rs = np.random.RandomState(self.random_state)
        q = rs.normal(size=(m.shape[1], k + 10))
        if m.dtype == np.float32:
            q = q.astype(np.float32)
        for _ in range(n_iter):
            q, _ = linalg.lu(m @ q, permute_l=True, check_finite=False)
            q, _ = linalg.lu(m.T @ q, permute_l=True, check_finite=False)
        q, _ = linalg.qr(m @ q, mode="economic", check_finite=False)
        uhat, s, vt = linalg.svd(q.T @ m, full_matrices=False)
        u = q @ uhat
        if transpose:
            return vt[:k].T, s[:k], u[:, :k].T
        return u[:, :k], s[:k], vt[:k]

    def fit_transform(self, x) -> np.ndarray:
        from scipy import linalg

        x = _float_array(x)
        n, f = x.shape
        k = self.n_components
        if not 1 <= k <= min(n, f):
            raise ValueError(f"n_components={k} must be between 1 and "
                             f"min(n_samples, n_features)={min(n, f)}")
        self.solver = self._solver(n, f)
        self.mean_ = x.mean(axis=0)
        if self.solver == "covariance_eigh":
            c = x.T @ x
            c -= n * self.mean_[:, None] * self.mean_[None, :]
            c /= n - 1
            _, vecs = np.linalg.eigh(c)
            _, vt = _svd_flip_v(None, np.flip(vecs, axis=1).T)
            self.components_ = vt[:k].copy()
            return self.transform(x)
        xc = x - self.mean_
        if self.solver == "full":
            u, s, vt = linalg.svd(xc, full_matrices=False)
        else:
            u, s, vt = self._randomized(xc)
        u, vt = _svd_flip_v(u, vt)
        self.components_ = vt[:k].copy()
        return u[:, :k] * s[:k]

    def transform(self, x) -> np.ndarray:
        x = _float_array(x)
        return x @ self.components_.T - self.mean_[None, :] @ self.components_.T


class SpectralClustering:
    """fit_predict with `labels_`, affinity 'rbf' (exp(-gamma * |x - y|^2))
    only, as scikit-learn's SpectralClustering(n_clusters, affinity='rbf',
    gamma, n_init, random_state) with assign_labels='kmeans'."""

    def __init__(self, n_clusters: int = 8, affinity: str = "rbf",
                 gamma: float = 1.0, n_init: int = 10,
                 random_state: Optional[int] = None):
        if affinity != "rbf":
            raise ValueError(f"affinity {affinity!r}: only 'rbf' is ported")
        self.n_clusters, self.gamma = n_clusters, gamma
        self.n_init, self.random_state = n_init, random_state
        self.labels_ = None

    def embedding(self, x) -> np.ndarray:
        """(n, n_clusters) spectral embedding of the rbf affinity graph."""
        x = np.asarray(x, np.float64)
        sq = (x * x).sum(axis=1)
        d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0)
        np.fill_diagonal(d2, 0.0)
        a = np.exp(-self.gamma * d2)
        np.fill_diagonal(a, 0.0)
        deg = a.sum(axis=1)
        dd = np.where(deg == 0, 1.0, np.sqrt(deg))
        lap = np.eye(len(x)) - a / dd[:, None] / dd[None, :]
        np.fill_diagonal(lap, (deg != 0).astype(np.float64))
        _, vecs = np.linalg.eigh(lap)
        emb = (vecs[:, :self.n_clusters] / dd[:, None]).T
        signs = np.sign(emb[np.arange(len(emb)), np.argmax(np.abs(emb), axis=1)])
        return (emb * signs[:, None]).T

    def fit_predict(self, x) -> np.ndarray:
        km = KMeans(n_clusters=self.n_clusters, random_state=self.random_state,
                    n_init=self.n_init)
        self.labels_ = km.fit_predict(self.embedding(x))
        return self.labels_


# --------------------------------------------------------------------------
# HDBSCAN, after scikit-learn's cluster/_hdbscan (hdbscan.py, _linkage.pyx,
# _tree.pyx): the same trees, in Python over the crop counts of a team fit

class _UnionFind:
    """scikit-learn's `_hierarchical_fast.UnionFind`: each union makes a
    new node, numbered from n."""

    def __init__(self, n: int):
        self.parent = np.full(2 * n - 1, -1, np.intp)
        self.size = np.concatenate([np.ones(n, np.intp), np.zeros(n - 1, np.intp)])
        self.next_label = n

    def union(self, m: int, n: int) -> None:
        self.parent[m] = self.parent[n] = self.next_label
        self.size[self.next_label] = self.size[m] + self.size[n]
        self.next_label += 1

    def find(self, n: int) -> int:
        p = n
        while self.parent[n] != -1:
            n = self.parent[n]
        while p != n and self.parent[p] != n:
            p, self.parent[p] = self.parent[p], n
        return n


class _TreeUnionFind:
    """scikit-learn's `_tree.TreeUnionFind` (union by rank)."""

    def __init__(self, size: int):
        self.parent = np.arange(size)
        self.rank = np.zeros(size, np.intp)

    def union(self, x: int, y: int) -> None:
        xr, yr = self.find(x), self.find(y)
        if self.rank[xr] < self.rank[yr]:
            self.parent[xr] = yr
        elif self.rank[xr] > self.rank[yr]:
            self.parent[yr] = xr
        else:
            self.parent[yr] = xr
            self.rank[xr] += 1

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            x, self.parent[x] = self.parent[x], root
        return root


def _mst(dist: np.ndarray, core: np.ndarray) -> np.ndarray:
    """Prim's tree of the mutual reachability graph from node 0, edges in
    the order scikit-learn's `mst_from_data_matrix` adds them: (n - 1, 3)
    rows of (source, new node, distance)."""
    n = len(dist)
    in_tree = np.zeros(n, bool)
    reach = np.full(n, np.inf)
    source = np.ones(n, np.intp)
    edges = np.empty((n - 1, 3))
    cur = 0
    for i in range(n - 1):
        in_tree[cur] = True
        mr = np.maximum(np.maximum(core[cur], core), dist[cur])
        better = (mr < reach) & ~in_tree
        reach = np.where(better, mr, reach)
        source = np.where(better, cur, source)
        cand = np.where(in_tree, np.inf, reach)
        new = int(np.argmin(cand))
        edges[i] = source[new], new, cand[new]
        cur = new
    return edges


def _single_linkage(edges: np.ndarray) -> np.ndarray:
    """(n - 1, 4) rows of (left, right, distance, size) from the MST, its
    edges sorted by distance (scikit-learn's `_process_mst`)."""
    edges = edges[np.argsort(edges[:, 2])]
    n = len(edges) + 1
    uf = _UnionFind(n)
    out = np.zeros((n - 1, 4))
    for i, (a, b, d) in enumerate(edges):
        ra, rb = uf.find(int(a)), uf.find(int(b))
        out[i] = ra, rb, d, uf.size[ra] + uf.size[rb]
        uf.union(ra, rb)
    return out


def _bfs_hierarchy(tree: np.ndarray, root: int) -> List[int]:
    n = len(tree) + 1
    queue, out = [root], []
    while queue:
        out.extend(queue)
        queue = [int(c) for x in queue if x >= n
                 for c in tree[x - n, :2]]
    return out


def _condense(tree: np.ndarray, min_cluster_size: int) -> np.ndarray:
    """(rows, 4) condensed tree of (parent, child, lambda, size)."""
    n = len(tree) + 1
    root = 2 * (n - 1)
    relabel = np.empty(root + 1, np.intp)
    relabel[root] = n
    next_label = n + 1
    ignore = np.zeros(root + 1, bool)
    rows = []

    def count(c):
        return int(tree[c - n, 3]) if c >= n else 1

    def points(c, parent, lam):
        for s in _bfs_hierarchy(tree, c):
            if s < n:
                rows.append((relabel[parent], s, lam, 1))
            ignore[s] = True

    for node in _bfs_hierarchy(tree, root):
        if ignore[node] or node < n:
            continue
        left, right, dist, _ = tree[node - n]
        left, right = int(left), int(right)
        lam = 1.0 / dist if dist > 0.0 else np.inf
        lc, rc = count(left), count(right)
        if lc >= min_cluster_size and rc >= min_cluster_size:
            relabel[left] = next_label
            rows.append((relabel[node], next_label, lam, lc))
            relabel[right] = next_label + 1
            rows.append((relabel[node], next_label + 1, lam, rc))
            next_label += 2
        elif lc < min_cluster_size and rc < min_cluster_size:
            points(left, node, lam)
            points(right, node, lam)
        elif lc < min_cluster_size:
            relabel[right] = relabel[node]
            points(left, node, lam)
        else:
            relabel[left] = relabel[node]
            points(right, node, lam)
    return np.array(rows, dtype=np.float64).reshape(-1, 4)


def _stability(ct: np.ndarray) -> Dict[int, float]:
    parents = ct[:, 0].astype(np.intp)
    children = ct[:, 1].astype(np.intp)
    smallest = parents.min()
    births = np.full(max(children.max(), smallest) + 1, np.nan)
    births[children] = ct[:, 2]
    births[smallest] = 0.0
    out = np.zeros(parents.max() - smallest + 1)
    for p, lam, size in zip(parents, ct[:, 2], ct[:, 3]):
        out[p - smallest] += (lam - births[p]) * size
    return {int(smallest + i): float(v) for i, v in enumerate(out)}


def _bfs_clusters(ct: np.ndarray, root: int) -> List[int]:
    out, queue = [], np.array([root])
    while len(queue):
        out.extend(queue.tolist())
        queue = ct[np.isin(ct[:, 0], queue), 1].astype(np.intp)
    return out


def _max_lambdas(ct: np.ndarray) -> np.ndarray:
    """Each parent's death lambda as scikit-learn's `max_lambdas` takes it:
    the largest lambda of the last run of consecutive rows under that
    parent (the condensed tree's rows of one parent need not be
    consecutive)."""
    parents = ct[:, 0].astype(np.intp)
    deaths = np.zeros(parents.max() + 1)
    cur, best = parents[0], ct[0, 2]
    for p, lam in zip(parents[1:], ct[1:, 2]):
        if p == cur:
            best = max(best, lam)
        else:
            deaths[cur] = best
            cur, best = p, lam
    deaths[cur] = best
    return deaths


def _eom_labels(ct: np.ndarray, n: int):
    """Excess-of-mass selection, the labels and their probabilities
    (scikit-learn's `_get_clusters`, `_do_labelling` and
    `get_probabilities`; allow_single_cluster False, no epsilon)."""
    stability = _stability(ct)
    nodes = sorted(stability, reverse=True)[:-1]
    tree = ct[ct[:, 3] > 1]
    is_cluster = {c: True for c in nodes}
    for node in nodes:
        sel = tree[:, 0] == node
        sub = float(np.sum([stability[int(c)] for c in tree[sel, 1]]))
        if sub > stability[node]:
            is_cluster[node] = False
            stability[node] = sub
        else:
            for s in _bfs_clusters(tree, node):
                if s != node:
                    is_cluster[s] = False
    clusters = {c for c, v in is_cluster.items() if v}
    cluster_map = {c: i for i, c in enumerate(sorted(clusters))}

    parents = ct[:, 0].astype(np.intp)
    children = ct[:, 1].astype(np.intp)
    root = parents.min()
    uf = _TreeUnionFind(parents.max() + 1)
    for p, c in zip(parents, children):
        if c not in clusters:
            uf.union(p, c)
    labels = np.full(n, -1, np.intp)
    for i in range(n):
        c = uf.find(i)
        if c != root:
            labels[i] = cluster_map[c]

    probs = np.zeros(n)
    deaths = _max_lambdas(ct)
    reverse = {i: c for c, i in cluster_map.items()}
    for p, c, lam in zip(parents, children, ct[:, 2]):
        if c >= root or labels[c] == -1:
            continue
        max_lam = deaths[reverse[labels[c]]]
        if max_lam == 0.0 or np.isinf(lam):
            probs[c] = 1.0
        else:
            probs[c] = min(lam, max_lam) / max_lam
    return labels, probs


class HDBSCAN:
    """fit / fit_predict with `labels_` (-1 for noise) and
    `probabilities_`, for the euclidean metric and 'eom' selection, as
    scikit-learn's HDBSCAN(min_cluster_size, min_samples)."""

    def __init__(self, min_cluster_size: int = 5,
                 min_samples: Optional[int] = None, metric: str = "euclidean",
                 cluster_selection_method: str = "eom"):
        if metric != "euclidean" or cluster_selection_method != "eom":
            raise ValueError("only the euclidean metric and 'eom' are ported")
        self.min_cluster_size = min_cluster_size
        self.min_samples = min_samples
        self.labels_ = self.probabilities_ = None

    def fit(self, x) -> "HDBSCAN":
        from scipy.spatial.distance import cdist

        x = np.asarray(x, np.float64)
        n = len(x)
        ms = self.min_cluster_size if self.min_samples is None else self.min_samples
        if n < 2:
            raise ValueError("HDBSCAN needs more than one sample")
        if ms > n:
            raise ValueError(f"min_samples ({ms}) must be at most the number "
                             f"of samples ({n})")
        dist = cdist(x, x)
        core = np.partition(dist, ms - 1, axis=1)[:, ms - 1]
        tree = _single_linkage(_mst(dist, core))
        ct = _condense(tree, self.min_cluster_size)
        self.labels_, self.probabilities_ = _eom_labels(ct, n)
        return self

    def fit_predict(self, x) -> np.ndarray:
        return self.fit(x).labels_
