"""Robust team classifier, embeddings plus masked colour features and
HDBSCAN: port of hockey_tpu/teams/robust.py (reference
team_robust.py:15-622, with the JAX package's two divergences: the fitted
path works, where the reference's crashes with a NameError, and the
embeddings are MobileNetV3's).

- The jersey-number mask: bright pixels (gray > 200) inside the centre
  ellipse (0.3 w, 0.2 h at (w // 2, 0.8 (h // 2))), dilated 5 x 5, are
  left out of every colour statistic.
- Features: the 576-d MobileNetV3 embedding (models/mobilenetv3.py) and
  the 43-dim masked colour vector x 20, plus the standardised positions
  x 0.1 where given.
- fit: crops under 50 x 25 pixels dropped; above 500 crops, 500 drawn
  without replacement in proportion to area x shape score by
  `np.random.default_rng(42)`; StandardScaler, PCA to at most 50
  components and HDBSCAN(min_cluster_size 5, min_samples 3, eom)
  (teams/cluster.py); the two clusters of largest size x mean
  membership probability become the teams, the one of lower median
  saturation team 0; with fewer than two clusters, saturation under 40
  decides.
- predict: the nearest fitted crop's team, unless it lies beyond twice
  the 95th percentile of the fitted crops' nearest-neighbour distances:
  then the player's stable history, else the nearest team profile or
  exemplar; then the temporal consistency bonus or override per tracker
  id, and confident assignments join the team's exemplars.

The JAX class first tries SigLIP embeddings through `transformers` from
local files (hockey_tpu robust.py:159-170). The port does not: the GPU
machine has neither `transformers` nor those weights, so the JAX class
takes its MobileNetV3 path there too.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..models import mobilenetv3 as mnv3
from ..ops.color import bgr_to_hsv, bgr_to_lab
from .base import standardize_crops, to_device_batch
from .cluster import HDBSCAN, PCA, StandardScaler
from .features import _hist, _masked_mean
from .hybrid import default_embedder


@dataclasses.dataclass
class TeamAssignment:
    team_id: int
    confidence: float
    is_outlier: bool = False


@dataclasses.dataclass
class PlayerProfile:
    tracker_id: int
    team_history: List[int]
    confidence_history: List[float]
    last_seen_frame: int

    def get_stable_team(self, min_confidence: float = 0.7) -> Optional[int]:
        if not self.team_history:
            return None
        confident = [t for t, c in zip(self.team_history, self.confidence_history)
                     if c >= min_confidence]
        return Counter(confident or self.team_history).most_common(1)[0][0]


def number_masks(crops: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 3) BGR -> (N, h, w) f32, 1 on the jersey and 0 on its
    number: bright pixels inside the centre ellipse, dilated 5 x 5
    (reference preprocess_crop)."""
    h, w = crops.shape[1:3]
    b, g, r = crops[..., 0], crops[..., 1], crops[..., 2]
    bright = (0.114 * b + 0.587 * g + 0.299 * r) > 200.0
    ys = (torch.arange(h, dtype=torch.float32, device=crops.device)
          - 0.8 * (h // 2))[:, None]
    xs = (torch.arange(w, dtype=torch.float32, device=crops.device)
          - (w // 2))[None, :]
    ellipse = (xs / max(w * 0.3, 1.0)) ** 2 + (ys / max(h * 0.2, 1.0)) ** 2 <= 1.0
    number = (bright & ellipse).float()
    return 1.0 - F.max_pool2d(number[:, None], 5, 1, 2)[:, 0]


def robust_color_features(crops: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 3) BGR -> (N, 43) over the number masks: [H hist 18,
    S hist 16, HSV mean / 255 x 3, LAB mean / 255 x 3, the shares of S < 30,
    30 <= S < 100 and S >= 100] (reference extract_color_features)."""
    n = crops.shape[0]
    m = number_masks(crops).reshape(n, -1)
    hsv = bgr_to_hsv(crops).reshape(n, -1, 3)
    lab = bgr_to_lab(crops).reshape(n, -1, 3)
    s = hsv[..., 1]
    return torch.cat([
        _hist(hsv[..., 0], m, 18, 180.0), _hist(s, m, 16, 256.0),
        torch.stack([_masked_mean(hsv[..., i], m) for i in range(3)], 1) / 255.0,
        torch.stack([_masked_mean(lab[..., i], m) for i in range(3)], 1) / 255.0,
        torch.stack([_masked_mean((s < 30).float(), m),
                     _masked_mean(((s >= 30) & (s < 100)).float(), m),
                     _masked_mean((s >= 100).float(), m)], 1),
    ], dim=1)


def masked_saturation_stats(crops: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 3) -> (N, 2): the masked mean saturation (the median's
    stand-in) and white ratio (V > 200 and S < 30)."""
    n = crops.shape[0]
    m = number_masks(crops).reshape(n, -1)
    hsv = bgr_to_hsv(crops).reshape(n, -1, 3)
    white = ((hsv[..., 2] > 200) & (hsv[..., 1] < 30)).float()
    return torch.stack([_masked_mean(hsv[..., 1], m), _masked_mean(white, m)], 1)


class RobustTeamClassifier:
    def __init__(self, device="cuda", min_cluster_size: int = 5,
                 min_samples: int = 3, seed: int = 0):
        self.device = resolve_device(device)
        self.min_cluster_size = min_cluster_size
        self.min_samples = min_samples
        self.scaler = StandardScaler()
        self.pca: Optional[PCA] = None
        self.color_feature_weight = 20.0
        self.team_mapping: Dict[int, int] = {}
        self.team_profiles: Dict[int, Dict] = {}
        self.team_exemplars: Dict[int, List[np.ndarray]] = {0: [], 1: []}
        self.player_profiles: Dict[int, PlayerProfile] = {}
        self.current_frame = 0
        self._train_reduced: Optional[np.ndarray] = None
        self._train_labels: Optional[np.ndarray] = None
        self._outlier_dist: float = np.inf
        self.net = default_embedder(self.device, seed)

    def _sat_white(self, crops) -> np.ndarray:
        return masked_saturation_stats(to_device_batch(crops, self.device)).cpu().numpy()

    def extract_multimodal_features(self, crops, positions=None) -> np.ndarray:
        """(N, 576 + 43 [+ 2]) f32: embedding, colour x 20, positions."""
        if isinstance(crops, (list, tuple)):
            crops = standardize_crops(crops)
        batch = to_device_batch(crops, self.device)
        visual = mnv3.embed(self.net, batch).cpu().numpy()
        color = robust_color_features(batch).cpu().numpy() * self.color_feature_weight
        combined = np.hstack([visual, color])
        if positions is not None and len(positions) == len(combined):
            pos = np.asarray(positions, np.float64)
            pos = (pos - pos.mean(axis=0)) / (pos.std(axis=0) + 1e-7)
            combined = np.hstack([combined, pos * 0.1])
        return combined.astype(np.float32)

    @staticmethod
    def filter_crops_for_clustering(crops, positions=None, min_size: int = 50):
        kept, kept_pos, scores = [], [], []
        for i, crop in enumerate(crops):
            h, w = crop.shape[:2]
            if h >= min_size and w >= min_size * 0.5:
                kept.append(crop)
                if positions is not None:
                    kept_pos.append(positions[i])
                scores.append(h * w * (1.0 if 0.4 <= w / h <= 0.8 else 0.5))
        return kept, (kept_pos if positions is not None else None), scores

    # ------------------------------------------------------------------
    def fit(self, crops: List[np.ndarray], positions=None) -> None:
        if len(crops) < self.min_cluster_size * 2:
            raise ValueError(f"Need at least {self.min_cluster_size * 2} crops")
        crops, positions, scores = self.filter_crops_for_clustering(crops, positions)
        if len(crops) < self.min_cluster_size * 2:
            raise ValueError(f"After filtering, only {len(crops)} crops remain")
        if len(crops) > 500:
            probs = np.asarray(scores, np.float64)
            rng = np.random.default_rng(42)
            idx = rng.choice(len(crops), size=500, replace=False,
                             p=probs / probs.sum())
            crops = [crops[i] for i in idx]
            if positions is not None:
                positions = [positions[i] for i in idx]

        scaled = self.scaler.fit_transform(
            self.extract_multimodal_features(crops, positions))
        self.pca = PCA(min(50, *scaled.shape), random_state=42)
        reduced = self.pca.fit_transform(scaled)
        clusterer = HDBSCAN(min_cluster_size=self.min_cluster_size,
                            min_samples=self.min_samples)
        labels = clusterer.fit_predict(reduced)
        self._map_clusters(crops, labels, reduced, clusterer.probabilities_)

    def _map_clusters(self, crops, labels, reduced, probabilities) -> None:
        uniq = sorted(set(labels.tolist()) - {-1})
        if len(uniq) < 2:
            self._fallback_clustering(crops, labels, reduced)
            return
        sat_white = self._sat_white(crops)
        stats = {}
        for lab in uniq:
            m = labels == lab
            stats[lab] = {
                "size": int(m.sum()),
                "median_saturation": float(np.median(sat_white[m, 0])),
                "white_ratio": float(np.median(sat_white[m, 1])),
                "cohesion": float(probabilities[m].mean()),
            }
        ranked = sorted(stats.items(), reverse=True,
                        key=lambda kv: kv[1]["size"] * kv[1]["cohesion"])[:2]
        if ranked[0][1]["median_saturation"] < ranked[1][1]["median_saturation"]:
            self.team_mapping = {ranked[0][0]: 0, ranked[1][0]: 1}
        else:
            self.team_mapping = {ranked[0][0]: 1, ranked[1][0]: 0}
        for cluster_id, team_id in self.team_mapping.items():
            cf = reduced[labels == cluster_id]
            center = cf.mean(axis=0)
            self.team_profiles[team_id] = {
                "cluster_id": cluster_id, "stats": stats[cluster_id],
                "exemplar_features": center}
            best = np.argsort(np.linalg.norm(cf - center, axis=1))[:10]
            self.team_exemplars[team_id] = [cf[i] for i in best]
        # the fitted crops stand in for hdbscan's approximate_predict
        keep = np.isin(labels, list(self.team_mapping))
        self._train_reduced = reduced[keep]
        self._train_labels = np.asarray(
            [self.team_mapping[lab] for lab in labels[keep]], np.int64)
        # the outlier gate: 2 x the 95th percentile of the fitted crops'
        # nearest-neighbour distances
        self._outlier_dist = float(np.percentile(
            self._knn_dists(self._train_reduced), 95)) * 2.0

    def _fallback_clustering(self, crops, labels, reduced) -> None:
        teams = np.where(self._sat_white(crops)[:, 0] < 40, 0, 1)
        self.team_mapping = {0: 0, 1: 1}
        self._train_reduced = reduced
        self._train_labels = teams.astype(np.int64)
        self._outlier_dist = np.inf
        for t in (0, 1):
            m = teams == t
            if m.any():
                self.team_profiles[t] = {
                    "cluster_id": t, "stats": {"size": int(m.sum())},
                    "exemplar_features": reduced[m].mean(axis=0)}

    def _knn_dists(self, feats: np.ndarray) -> np.ndarray:
        d2 = ((feats[:, None, :] - self._train_reduced[None, :, :]) ** 2).sum(-1)
        d2.partition(1, axis=1)
        return np.sqrt(np.maximum(d2[:, 1], 0))

    def reduce(self, features: np.ndarray) -> np.ndarray:
        """Fitted: the scaler and the PCA; unfitted: the features."""
        if self._train_reduced is None:
            return features
        return self.pca.transform(self.scaler.transform(features))

    # ------------------------------------------------------------------
    def predict(self, crops, tracker_ids=None, positions=None) -> List[TeamAssignment]:
        if not len(crops):
            return []
        self.current_frame += 1
        reduced = self.reduce(self.extract_multimodal_features(crops, positions))
        fitted = self._train_reduced is not None
        sat_white = self._sat_white(crops)
        assignments: List[TeamAssignment] = []
        for i in range(len(crops)):
            tid = None
            if tracker_ids is not None and i < len(tracker_ids) \
                    and tracker_ids[i] is not None:
                tid = int(tracker_ids[i])
            if fitted:
                d2 = ((self._train_reduced - reduced[i]) ** 2).sum(-1)
                j = int(np.argmin(d2))
                dist = float(np.sqrt(d2[j]))
                if dist > self._outlier_dist:
                    a = self._handle_outlier(sat_white[i], reduced[i], tid)
                else:
                    strength = max(0.0, 1.0 - dist / max(self._outlier_dist, 1e-6))
                    a = TeamAssignment(int(self._train_labels[j]),
                                       0.5 + 0.5 * strength, False)
            else:
                a = self._simple_predict(sat_white[i])
            if tid is not None:
                a = self._apply_temporal_consistency(a, tid)
            if a.confidence > 0.85 and not a.is_outlier \
                    and a.team_id in self.team_exemplars:
                ex = self.team_exemplars[a.team_id]
                ex.append(reduced[i])
                del ex[:-50]
            assignments.append(a)
        return assignments

    def _handle_outlier(self, sat_white, feat, tid) -> TeamAssignment:
        if tid is not None and tid in self.player_profiles:
            stable = self.player_profiles[tid].get_stable_team()
            if stable is not None:
                return TeamAssignment(stable, 0.6, True)
        if self.team_profiles:
            best, min_dist = 0, np.inf
            for team_id, prof in self.team_profiles.items():
                d = float(np.linalg.norm(feat - prof["exemplar_features"]))
                if d < min_dist:
                    min_dist, best = d, team_id
            for team_id, exemplars in self.team_exemplars.items():
                if exemplars:
                    d = float(np.min(np.linalg.norm(np.asarray(exemplars) - feat,
                                                    axis=1)))
                    if d < min_dist:
                        min_dist, best = d, team_id
            return TeamAssignment(best, max(0.3, 1.0 - min_dist / 500.0), True)
        return self._simple_predict(sat_white)

    @staticmethod
    def _simple_predict(sat_white) -> TeamAssignment:
        sat = float(sat_white[0])
        if sat < 40:
            return TeamAssignment(0, 1.0 - sat / 40.0, False)
        return TeamAssignment(1, min(sat / 100.0, 1.0), False)

    def _apply_temporal_consistency(self, a: TeamAssignment, tid: int) -> TeamAssignment:
        prof = self.player_profiles.setdefault(
            tid, PlayerProfile(tid, [], [], self.current_frame))
        prof.team_history.append(a.team_id)
        prof.confidence_history.append(a.confidence)
        prof.last_seen_frame = self.current_frame
        del prof.team_history[:-20]
        del prof.confidence_history[:-20]
        stable = prof.get_stable_team(min_confidence=0.6)
        if stable is not None and len(prof.team_history) >= 5:
            recent = prof.team_history[-5:]
            consistency = recent.count(stable) / len(recent)
            if stable == a.team_id:
                return TeamAssignment(a.team_id, min(a.confidence + consistency * 0.2, 1.0),
                                      a.is_outlier)
            if consistency > 0.8:
                return TeamAssignment(stable, consistency, a.is_outlier)
            return TeamAssignment(a.team_id, a.confidence * (1 - consistency * 0.3),
                                  a.is_outlier)
        return a

    @staticmethod
    def get_team_labels(assignments: List[TeamAssignment]) -> np.ndarray:
        return np.asarray([a.team_id for a in assignments])

    @staticmethod
    def get_confidences(assignments: List[TeamAssignment]) -> np.ndarray:
        return np.asarray([a.confidence for a in assignments])
