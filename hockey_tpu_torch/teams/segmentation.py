"""Segmentation team classifier, the first strategy of the cascade: port of
hockey_tpu/teams/segmentation.py (reference team_segmentation.py:9-298).

- Each crop is segmented to a jersey mask and reduced to the 4-dim
  feature [white_ratio, dominant_hue, saturation, brightness].
- fit: two-cluster k-means (teams/kmeans.py, for scikit-learn's
  KMeans(k=2, seed 42, n_init=10)) over at most 50 crops with more than
  500 mask pixels, relabelled so that the cluster of higher white ratio is
  team 0 (away, white). Where the two white ratios tie, the labels follow
  the clusters' order alone.
- predict: nearest centre, then the temporal majority vote (window 10,
  minimum 3); unfitted, white_ratio > 0.4 is team 0.
- Masks are kept per tracker id for visualisation.

Masks are the colour-prior masks of teams/features.py by default (one
batched call); method='grabcut' runs the reference's host GrabCut.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.crop_resize import crop_and_resize
from .base import CROP_H, CROP_W, MajorityVote, to_device_batch
from .features import color_prior_masks, grabcut_mask_host, segmentation_features
from .kmeans import KMeans


def frame_features(frame: torch.Tensor, boxes: torch.Tensor):
    """Crops of `boxes` (N, 4) sampled from `frame` (H, W, 3), their
    colour-prior masks and 4-dim features -> (feats (N, 4), masks (N, h, w)).
    A crop whose mask holds under 100 pixels takes the defaults."""
    crops = crop_and_resize(frame, boxes, (CROP_H, CROP_W))
    masks = color_prior_masks(crops)
    return segmentation_features(crops, masks), masks


class SegmentationTeamClassifier:
    def __init__(self, device="cuda", visualize_segmentation: bool = False,
                 method: str = "color_prior"):
        self.device = resolve_device(device)
        self.visualize_segmentation = visualize_segmentation
        self.method = method
        self.vote = MajorityVote(window=10, min_votes=3)
        self.kmeans: Optional[KMeans] = None
        self.team_colors = None
        self.last_masks: Dict[int, np.ndarray] = {}

    @classmethod
    def from_fitted(cls, cluster_centers: np.ndarray, team_colors: Optional[Dict],
                    device="cuda", **kwargs) -> "SegmentationTeamClassifier":
        """A fitted classifier from another's state: its (2, 4) cluster
        centres (team 0's first; scikit-learn's `cluster_centers_` of the
        JAX package's classifier) and its `team_colors`."""
        clf = cls(device, **kwargs)
        clf.kmeans = KMeans(n_clusters=2)
        clf.kmeans.cluster_centers_ = np.asarray(cluster_centers, np.float64)
        clf.team_colors = None if team_colors is None else {
            int(k): dict(v) for k, v in team_colors.items()}
        return clf

    # ------------------------------------------------------------------
    def _masks(self, batch: torch.Tensor) -> torch.Tensor:
        if self.method == "grabcut":
            return torch.as_tensor(np.stack([
                grabcut_mask_host(c.astype(np.uint8))
                for c in batch.cpu().numpy()])).to(batch.device)
        return color_prior_masks(batch)

    def _features(self, crops):
        """-> (feats (N, 4), masks (N, h, w)) on the host."""
        batch = to_device_batch(crops, self.device)
        masks = self._masks(batch)
        feats = segmentation_features(batch, masks)
        return feats.cpu().numpy(), masks.cpu().numpy()

    def _classify(self, feats: np.ndarray, tracker_ids) -> np.ndarray:
        if self.kmeans is not None:
            teams = self.kmeans.predict(feats)
        else:  # unfitted: white_ratio > 0.4 -> team 0
            teams = np.where(feats[:, 0] > 0.4, 0, 1)
        return self.vote.update(tracker_ids, teams.astype(np.int64))

    def _keep_masks(self, masks: np.ndarray, tracker_ids) -> None:
        for i, tid in enumerate(tracker_ids[: len(masks)]):
            if tid is not None:
                self.last_masks[int(tid)] = masks[i] > 0.5

    # ------------------------------------------------------------------
    def fit(self, crops: List[np.ndarray], positions=None, **_) -> None:
        crops = list(crops)[:50]  # the reference's limit (team_segmentation.py:181)
        if len(crops) < 2:
            return
        feats, masks = self._features(crops)
        feats = feats[masks.reshape(len(crops), -1).sum(axis=1) > 500]
        if len(feats) < 2:
            # the reference falls back to the threshold rule when too few
            # crops segment (:195-197)
            return
        self.kmeans = KMeans(n_clusters=2, random_state=42, n_init=10)
        labels = self.kmeans.fit_predict(feats)
        white = [float(feats[labels == c, 0].mean()) if (labels == c).any()
                 else 0.0 for c in (0, 1)]
        if white[1] > white[0]:
            self.kmeans.cluster_centers_ = self.kmeans.cluster_centers_[[1, 0]]
            white = white[::-1]
        self.team_colors = {
            0: {"is_white": white[0], "name": "Away (White)"},
            1: {"is_white": white[1], "name": "Home (Colored)"},
        }

    def predict(self, crops, tracker_ids: Optional[np.ndarray] = None,
                positions=None) -> np.ndarray:
        if not len(crops):
            return np.array([])
        feats, masks = self._features(crops)
        if not self.visualize_segmentation:
            self.last_masks.clear()
        elif tracker_ids is not None:
            self._keep_masks(masks, tracker_ids)
        return self._classify(feats, tracker_ids)

    def get_segmentation_masks(self, tracker_ids: List[int]) -> Dict[int, np.ndarray]:
        return {t: self.last_masks[t] for t in tracker_ids if t in self.last_masks}

    def predict_features(self, feats: np.ndarray,
                         tracker_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Classify precomputed 4-dim features, such as the fused detect
        step's columns 7-10: nearest centre and the vote, no device call."""
        feats = np.asarray(feats, np.float32).reshape(-1, 4)
        if len(feats) == 0:
            return np.array([])
        return self._classify(feats, tracker_ids)

    def predict_from_frame(self, frame: np.ndarray, boxes: np.ndarray,
                           tracker_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Crops sampled on the device straight from the frame, no host
        crops."""
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        if len(boxes) == 0:
            return np.array([])
        feats, masks = frame_features(
            torch.as_tensor(np.asarray(frame)).to(self.device),
            torch.from_numpy(boxes).to(self.device))
        feats = feats.cpu().numpy()
        if self.visualize_segmentation and tracker_ids is not None:
            self._keep_masks(masks.cpu().numpy(), tracker_ids)
        return self._classify(feats, tracker_ids)
