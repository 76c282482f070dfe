"""The port's own clusterings (hockey_tpu_torch/teams/cluster.py) against
scikit-learn, on the CPU, on numpy-seeded separated blobs with uniform
noise, parametrised over seeds.

Tolerances, and why:
- HDBSCAN: labels equal up to a permutation of the clusters, noise (-1)
  equal, probabilities within 1e-9 (the same float64 steps; only the
  distances' summation order differs from scikit-learn's KD-tree);
- SpectralClustering: the same partition up to the labels' order (a dense
  eigh for ARPACK, the port's k-means for scikit-learn's);
- PCA: the same solver, components and projections within 1e-4 + 1e-5
  |value| in f32 (a few ulps of projections up to ~350; the same LAPACK
  steps on the same random stream, BLAS products may sum in another
  order; measured 2.4e-4 on 346), float64 within 1e-8;
- StandardScaler: within one f32 ulp of the values (4.8e-7), its mean
  and scale within 1e-12 in float64.
"""

import numpy as np
import pytest
from sklearn.cluster import HDBSCAN as SkHDBSCAN
from sklearn.cluster import SpectralClustering as SkSpectral
from sklearn.decomposition import PCA as SkPCA
from sklearn.preprocessing import StandardScaler as SkScaler

from hockey_tpu_torch.teams import cluster
from tests.test_torch_session import one_torch_thread  # noqa: F401

SEEDS = range(6)


def blobs(seed: int, sizes=(60, 45, 30), dim: int = 8, noise: int = 12):
    """Gaussian blobs (sd 0.6) at uniform centres in [-10, 10]^dim, plus
    `noise` uniform points in [-14, 14]^dim."""
    rng = np.random.default_rng(seed)
    xs = [rng.normal(rng.uniform(-10, 10, dim), 0.6, (n, dim)) for n in sizes]
    xs.append(rng.uniform(-14, 14, (noise, dim)))
    return np.concatenate(xs)


def same_partition(a, b) -> bool:
    """Equal up to a renaming of the non-noise labels, noise equal."""
    a, b = np.asarray(a), np.asarray(b)
    if not np.array_equal(a == -1, b == -1):
        return False
    pairs = set(zip(a[a >= 0].tolist(), b[b >= 0].tolist()))
    return len(pairs) == len({p for p, _ in pairs}) == len({q for _, q in pairs})


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("min_cluster_size,min_samples", [(5, 3), (8, None)])
def test_hdbscan_matches_sklearn(seed, min_cluster_size, min_samples):
    x = blobs(seed)
    ref = SkHDBSCAN(min_cluster_size=min_cluster_size, min_samples=min_samples,
                    copy=True).fit(x)
    got = cluster.HDBSCAN(min_cluster_size=min_cluster_size,
                          min_samples=min_samples).fit(x)
    assert same_partition(got.labels_, ref.labels_)
    assert len(set(got.labels_.tolist()) - {-1}) >= 2
    np.testing.assert_allclose(got.probabilities_, ref.probabilities_,
                               rtol=0, atol=1e-9)


def test_hdbscan_rejects_too_few_samples():
    with pytest.raises(ValueError):
        cluster.HDBSCAN(min_cluster_size=5, min_samples=3).fit(np.zeros((2, 3)))


@pytest.mark.parametrize("seed", SEEDS)
def test_spectral_matches_sklearn(seed):
    x = blobs(seed, noise=0)
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
    gamma = 1.0 / np.median(d2[d2 > 0])  # the hybrid classifier's gamma
    kw = dict(n_clusters=3, affinity="rbf", gamma=gamma, n_init=10, random_state=42)
    ref = SkSpectral(**kw).fit_predict(x)
    got = cluster.SpectralClustering(**kw).fit_predict(x)
    assert same_partition(got, ref) and len(set(got.tolist())) == 3


@pytest.mark.parametrize("shape,solver", [
    ((40, 621), "full"), ((200, 621), "randomized"),
    ((500, 30), "covariance_eigh"), ((100, 30), "full")])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pca_matches_sklearn(shape, solver, dtype):
    """The robust classifier's shapes (crops x 576 + 43 + 2 features) and
    small ones, on low-rank data with noise."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(shape[0], 5)) * 10 @ rng.normal(size=(5, shape[1]))
         + rng.normal(size=shape)).astype(dtype)
    k = min(50, *shape)
    ref = SkPCA(n_components=k, random_state=42)
    want = ref.fit_transform(x)
    pca = cluster.PCA(k, random_state=42)
    got = pca.fit_transform(x)
    assert pca.solver == ref._fit_svd_solver == solver
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == np.float32 else dict(rtol=0, atol=1e-8)
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(pca.components_, ref.components_, **tol)
    y = x[:7] + 1
    np.testing.assert_allclose(pca.transform(y), ref.transform(y), **tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_standard_scaler_matches_sklearn(dtype):
    rng = np.random.default_rng(2)
    x = (rng.normal(5, 3, (80, 12)) * rng.uniform(0.1, 50, 12)).astype(dtype)
    x[:, 3] = 7.0  # a constant feature scales by 1
    ref = SkScaler().fit(x)
    got = cluster.StandardScaler().fit(x)
    np.testing.assert_allclose(got.mean_, ref.mean_, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.scale_, ref.scale_, rtol=1e-12, atol=0)
    assert got.scale_[3] == 1.0
    out, want = got.transform(x), ref.transform(x)
    assert out.dtype == want.dtype == dtype
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=4.8e-7 if dtype == np.float32 else 1e-12)
