"""Simple white-versus-coloured jersey classifier, the last strategy of the
cascade: port of hockey_tpu/teams/simple.py (reference team.py:76-132,
274-302).

- torso crop: rows 25-75 %, columns 30-70 %;
- white if the white-pixel ratio exceeds 0.3, or mean V > 180 with mean
  S < 50;
- confidence: white min(2 * white_ratio, 1), coloured min(S / 150, 1);
- the temporal majority vote, window 10, minimum 3.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.device import resolve_device
from .base import MajorityVote, to_device_batch
from .features import simple_jersey_stats


def _torso(crop: np.ndarray) -> np.ndarray:
    h, w = crop.shape[:2]
    if h < 30 or w < 20:
        return crop
    region = crop[int(h * 0.25): int(h * 0.75), int(w * 0.3): int(w * 0.7)]
    return region if region.size else crop


class SimpleTeamClassifier:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.vote = MajorityVote(window=10, min_votes=3)

    def classify_batch(self, crops) -> Tuple[np.ndarray, np.ndarray]:
        """-> (team ids (N,), confidences (N,))."""
        if isinstance(crops, (list, tuple)):
            crops = [_torso(np.asarray(c)) for c in crops]
        stats = simple_jersey_stats(to_device_batch(crops, self.device))
        white_ratio, brightness, saturation = stats.cpu().numpy().T
        is_white = (white_ratio > 0.3) | ((brightness > 180) & (saturation < 50))
        teams = np.where(is_white, 0, 1).astype(np.int64)
        conf = np.where(is_white, np.minimum(white_ratio * 2.0, 1.0),
                        np.minimum(saturation / 150.0, 1.0))
        return teams, conf.astype(np.float32)

    def fit(self, crops: List[np.ndarray], positions=None, **_) -> None:
        """Nothing to fit: the reference's _simple_fit only prints the
        distribution of the first 100 crops (team.py:202-217)."""
        if len(crops):
            self.classify_batch(crops[:100])

    def predict(self, crops, tracker_ids: Optional[np.ndarray] = None,
                positions=None) -> np.ndarray:
        if not len(crops):
            return np.array([])
        teams, _ = self.classify_batch(crops)
        return self.vote.update(tracker_ids, teams)
