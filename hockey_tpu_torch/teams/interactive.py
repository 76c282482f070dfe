"""Interactive example-based team classifier: port of
hockey_tpu/teams/interactive.py (reference team_interactive.py:37-410).

- The user marks 2-5 example players per team (the click UI is
  ui/team_selector.py `pick_team_examples`; `initialize_from_examples`
  takes crops without a display); their crops become the exemplars.
- Features per crop (113): HSV histograms of 30 / 32 / 32 bins, the HSV
  mean and standard deviation / 255, the four quadrants' HSV means / 255,
  and the edge density (the fraction of pixels whose central-difference
  gradient magnitude of the gray image exceeds 100; the JAX package's
  stand-in for Canny), for the whole batch in one pass on the device.
- Similarity: the mean of the three histograms' Pearson correlations,
  1 / (1 + L2) of the mean, std and quadrant blocks, and 1 - |edge
  difference|; a crop takes the team of its most similar exemplar, and
  where that similarity is under 0.7 with at least 5 votes of history
  (window 10) the majority of the history overrides it.
- A warning when the two teams' exemplars are more than 0.75 similar.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.color import bgr_to_hsv
from .base import to_device_batch
from .features import _hist

# the packed vector's blocks
_H, _S, _V = 30, 32, 32
_QUAD = 12          # 4 quadrants x HSV mean / 255
DIM = _H + _S + _V + 6 + _QUAD + 1  # 113


def interactive_features(crops: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 3) BGR crops -> (N, 113) packed feature vectors
    (hockey_tpu interactive.py:45-79)."""
    n, h, w = crops.shape[:3]
    hsv = bgr_to_hsv(crops)
    flat = hsv.reshape(n, -1, 3)
    ones = torch.ones_like(flat[..., 0])
    quads = [hsv[:, :h // 2, :w // 2], hsv[:, :h // 2, w // 2:],
             hsv[:, h // 2:, :w // 2], hsv[:, h // 2:, w // 2:]]
    b, g, r = crops[..., 0], crops[..., 1], crops[..., 2]
    gray = 0.114 * b + 0.587 * g + 0.299 * r
    gx = gray[:, :, 2:] - gray[:, :, :-2]
    gy = gray[:, 2:, :] - gray[:, :-2, :]
    mag = torch.sqrt(gx[:, 1:-1, :] ** 2 + gy[:, :, 1:-1] ** 2)
    return torch.cat([
        _hist(flat[..., 0], ones, _H, 180.0), _hist(flat[..., 1], ones, _S, 256.0),
        _hist(flat[..., 2], ones, _V, 256.0),
        flat.mean(dim=1) / 255.0, flat.std(dim=1, unbiased=False) / 255.0,
        torch.cat([q.mean(dim=(1, 2)) / 255.0 for q in quads], dim=1),
        (mag > 100.0).float().mean(dim=(1, 2))[:, None],
    ], dim=1)


def _block_corr(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pearson correlation of the rows of a (N, D) with the rows of b
    (M, D) -> (N, M) (cv2.HISTCMP_CORREL)."""
    ac = a - a.mean(axis=1, keepdims=True)
    bc = b - b.mean(axis=1, keepdims=True)
    den = np.sqrt((ac ** 2).sum(1))[:, None] * np.sqrt((bc ** 2).sum(1))[None, :]
    return (ac @ bc.T) / np.maximum(den, 1e-12)


def similarity_matrix(fa: np.ndarray, fb: np.ndarray) -> np.ndarray:
    """(N, 113) x (M, 113) -> (N, M) similarity, the reference's
    compute_similarity (hockey_tpu interactive.py:81-108)."""
    o, terms = 0, []
    for n in (_H, _S, _V):
        terms.append(_block_corr(fa[:, o:o + n], fb[:, o:o + n]))
        o += n
    for n in (3, 3, _QUAD):
        d = np.linalg.norm(fa[:, o:o + n, None].transpose(0, 2, 1)
                           - fb[None, :, o:o + n], axis=2)
        terms.append(1.0 / (1.0 + d))
        o += n
    terms.append(1.0 - np.abs(fa[:, o, None] - fb[None, :, o]))
    return np.mean(terms, axis=0)


class InteractiveTeamClassifier:
    def __init__(self, device="cuda", confidence_threshold: float = 0.7):
        self.device = resolve_device(device)
        self.confidence_threshold = confidence_threshold
        self.examples: Dict[int, np.ndarray] = {}  # team -> (M, 113)
        self.example_crops: Dict[int, List[np.ndarray]] = {}  # for the montage
        self.player_history: Dict[int, List[int]] = defaultdict(list)
        self.history_window = 10
        self.min_examples_per_team = 2
        self.max_examples_per_team = 5

    def features(self, crops) -> np.ndarray:
        return interactive_features(to_device_batch(crops, self.device)).cpu().numpy()

    def initialize_from_examples(self, team0_crops: List[np.ndarray],
                                 team1_crops: List[np.ndarray]) -> bool:
        """Initialisation with pre-picked example crops, no display."""
        if (len(team0_crops) < self.min_examples_per_team
                or len(team1_crops) < self.min_examples_per_team):
            return False
        m = self.max_examples_per_team
        self.examples = {0: self.features(team0_crops)[:m],
                         1: self.features(team1_crops)[:m]}
        self.example_crops = {0: [np.asarray(c) for c in team0_crops[:m]],
                              1: [np.asarray(c) for c in team1_crops[:m]]}
        inter = float(similarity_matrix(self.examples[0], self.examples[1]).mean())
        if inter > 0.75:
            print(f"WARNING: Teams look similar (avg similarity: {inter:.2f})")
        return True

    def visualize_examples(self) -> Optional[np.ndarray]:
        """Montage of the example crops: one 100-px row per team, 10-px
        gaps and count labels (reference team_interactive.py:357-410).
        Needs OpenCV, imported here."""
        import cv2

        if len(self.example_crops) < 2:
            return None
        target_height, gap = 100, 10
        team_images = []
        for team_id in (0, 1):
            crops = []
            for crop in self.example_crops[team_id]:
                scale = target_height / max(crop.shape[0], 1)
                crops.append(cv2.resize(
                    crop, (max(int(crop.shape[1] * scale), 1), target_height)))
            row = []
            for c in crops[:-1]:
                row.extend([c, np.full((target_height, gap, 3), 255, np.uint8)])
            row.append(crops[-1])
            team_images.append(np.hstack(row))
        max_width = max(img.shape[1] for img in team_images)
        for i, img in enumerate(team_images):
            if img.shape[1] < max_width:
                pad = np.full((target_height, max_width - img.shape[1], 3),
                              255, np.uint8)
                team_images[i] = np.hstack([img, pad])
        y0 = 30
        canvas = np.full((target_height * 2 + gap * 3 + 60, max_width, 3),
                         255, np.uint8)
        canvas[y0: y0 + target_height] = team_images[0]
        canvas[y0 + target_height + gap: y0 + target_height * 2 + gap] = \
            team_images[1]
        n0, n1 = len(self.example_crops[0]), len(self.example_crops[1])
        cv2.putText(canvas, f"Team 0 (White/Away) - {n0} examples", (10, 20),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 0, 0), 2)
        cv2.putText(canvas, f"Team 1 (Colored/Home) - {n1} examples",
                    (10, y0 + target_height + gap - 10),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 0, 0), 2)
        return canvas

    def initialize_from_user_selection(self, frame, detections) -> bool:
        """The click UI (reference :54-132): `detections` is (boxes,
        tracker_ids) or has `.xyxy`. False without a display or when
        cancelled."""
        from ..ui.team_selector import pick_team_examples

        boxes = detections[0] if isinstance(detections, tuple) else detections.xyxy
        picked = pick_team_examples(frame, np.asarray(boxes))
        if picked is None:
            return False

        def crops(bs):
            return [frame[int(b[1]):int(b[3]), int(b[0]):int(b[2])] for b in bs]

        return self.initialize_from_examples(crops(picked[0]), crops(picked[1]))

    def predict(self, crops, tracker_ids: Optional[np.ndarray] = None) -> np.ndarray:
        if len(self.examples) < 2:
            raise ValueError("Must initialize with user selection first!")
        if not len(crops):
            return np.array([])
        feats = self.features(crops)
        sim = np.stack([similarity_matrix(feats, self.examples[t]).max(axis=1)
                        for t in (0, 1)], axis=1)
        teams = np.argmax(sim, axis=1)
        confs = sim[np.arange(len(teams)), teams]
        if tracker_ids is not None:
            for i, tid in enumerate(tracker_ids[: len(teams)]):
                if tid is None:
                    continue
                h = self.player_history[int(tid)]
                h.append(int(teams[i]))
                del h[: -self.history_window]
                if len(h) >= 5 and confs[i] < self.confidence_threshold:
                    teams[i] = int(np.argmax(np.bincount(h)))
        return teams.astype(np.int64)
