"""Hybrid team classifier, deep embeddings plus colour features: port of
hockey_tpu/teams/hybrid.py (reference team_hybrid.py:13-328).

- The jersey region: rows 10-60 %, columns 20-80 % of crops of at least
  40 x 20 pixels.
- Features: the 576-d MobileNetV3 embedding (models/mobilenetv3.py, one
  batched forward on the classifier's device) and the 49-dim colour
  vector (teams/features.py), 625 in all.
- fit: StandardScaler, the positions x 0.1 where given, then spectral
  clustering (rbf, n_init 10, seed 42; teams/cluster.py) with the
  median-distance gamma the JAX package uses in place of the reference's
  gamma 1 (hockey_tpu hybrid.py:79-91); the cluster of lower mean
  saturation becomes team 0 (white, away).
- predict: the 5 nearest fitted crops vote (the JAX package's kNN over
  its fitted features, hockey_tpu hybrid.py:119), the reference's
  white-ratio heuristic while unfitted, then the temporal majority vote
  (window 15, minimum 5).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import mobilenetv3 as mnv3
from .base import MajorityVote, standardize_crops, to_device_batch
from .cluster import SpectralClustering, StandardScaler
from .features import hybrid_color_features


def _jersey_region(crop: np.ndarray) -> np.ndarray:
    h, w = crop.shape[:2]
    if h < 40 or w < 20:
        return crop
    return crop[int(h * 0.1): int(h * 0.6), int(w * 0.2): int(w * 0.8)]


def default_embedder(device, seed: int = 0) -> mnv3.MobileNetV3:
    """MobileNetV3 with the shipped weights on `device`, or a random tree
    drawn from `seed` where they are absent."""
    params = mnv3.load_default_params()
    if params is None:
        params = mnv3.init_params(torch.Generator().manual_seed(seed))
    return mnv3.build_embedder(params, device)


class HybridTeamClassifier:
    KNN_K = 5

    def __init__(self, device="cuda", n_clusters: int = 2, seed: int = 0):
        self.device = resolve_device(device)
        self.n_clusters = n_clusters
        self.vote = MajorityVote(window=15, min_votes=5)
        self.scaler = StandardScaler()
        self.net = default_embedder(self.device, seed)
        self.fitted_features: Optional[np.ndarray] = None
        self.fitted_labels: Optional[np.ndarray] = None

    def extract_all_features(self, crops) -> np.ndarray:
        """(N, 576 + 49) f32: the embedding and the colour vector of each
        crop (a list is cut to its jersey regions and standardised)."""
        if isinstance(crops, (list, tuple)):
            crops = standardize_crops([_jersey_region(np.asarray(c)) for c in crops])
        batch = to_device_batch(crops, self.device)
        deep = mnv3.embed(self.net, batch)
        color = hybrid_color_features(batch, torch.ones_like(batch[..., 0]))
        return torch.cat([deep, color], dim=1).cpu().numpy().astype(np.float32)

    def fit(self, crops: List[np.ndarray], positions=None) -> None:
        if len(crops) < self.n_clusters * 2:
            raise ValueError(f"Need at least {self.n_clusters * 2} crops for clustering")
        feats = self.extract_all_features(crops)
        normed = self.scaler.fit_transform(feats)
        if positions is not None and len(positions) == len(crops):
            pos = np.asarray(positions, np.float64)
            lo, hi = pos.min(axis=0), pos.max(axis=0)
            pos = (pos - lo) / (hi - lo + 1e-7)
            normed_sc = np.hstack([normed, pos * 0.1])
        else:
            normed_sc = normed
        d2 = ((normed_sc[:, None, :] - normed_sc[None, :, :]) ** 2).sum(-1)
        med = float(np.median(d2[d2 > 0])) if (d2 > 0).any() else 1.0
        clusterer = SpectralClustering(
            n_clusters=self.n_clusters, affinity="rbf",
            gamma=1.0 / max(med, 1e-9), n_init=10, random_state=42)
        labels = self._orient_labels(feats, clusterer.fit_predict(normed_sc))
        self.fitted_features = normed
        self.fitted_labels = labels

    def _orient_labels(self, feats: np.ndarray, labels: np.ndarray) -> np.ndarray:
        """Team 0 = the cluster of lower mean saturation (feature 35: the
        HSV mean's S after the 18 + 8 + 8 histogram bins)."""
        sat_idx = 18 + 8 + 8 + 1
        sats = [feats[labels == c, sat_idx].mean() if (labels == c).any() else 1e9
                for c in range(self.n_clusters)]
        if self.n_clusters == 2 and sats[1] < sats[0]:
            labels = 1 - labels
        return labels

    def classify_features(self, feats: np.ndarray) -> np.ndarray:
        """Teams of (N, 625) features before the vote: the kNN over the
        fitted crops, or the heuristic while unfitted."""
        if self.fitted_features is None:
            return self._heuristic(feats)
        return self._knn(self.scaler.transform(feats))

    def predict(self, crops, tracker_ids: Optional[np.ndarray] = None) -> np.ndarray:
        if not len(crops):
            return np.array([])
        teams = self.classify_features(self.extract_all_features(crops))
        return self.vote.update(tracker_ids, teams)

    def _knn(self, feats: np.ndarray) -> np.ndarray:
        d2 = ((feats[:, None, :] - self.fitted_features[None, :, :]) ** 2).sum(-1)
        k = min(self.KNN_K, len(self.fitted_features))
        nearest = np.argpartition(d2, k - 1, axis=1)[:, :k]
        return (self.fitted_labels[nearest].mean(axis=1) > 0.5).astype(np.int64)

    @staticmethod
    def _heuristic(feats: np.ndarray) -> np.ndarray:
        """Unfitted: white if white_ratio > 0.3 or the lowest saturation
        bin dominates (team_hybrid.py:270-278)."""
        low_bin = np.argmax(feats[:, 18:26], axis=1) == 0
        return np.where((feats[:, -1] > 0.3) | low_bin, 0, 1).astype(np.int64)
