"""Temporal homography stabilisation: the port's own copy of
hockey_tpu/homography/stabilizer.py (numpy only).

- a new homography that agrees with the running estimate is blended into
  it (EMA on the normalised matrix); a jump is taken only when it
  persists `jump_persistence` frames (a camera cut);
- lock / unlock (the calibrator's 'L' key) freezes the estimate;
- two quality tiers: 'fine' fits (3-ft gate) are authoritative; a
  'coarse' fit seeds or refines a coarse estimate and displaces a fine one
  only after `fine_ttl` frames without a fine fit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .ransac import project


def _normalize(h: np.ndarray) -> np.ndarray:
    return h / h[2, 2]


def homography_distance(h1: np.ndarray, h2: np.ndarray,
                        frame_hw=(1080, 1920)) -> float:
    """Mean displacement (rink units) of a probe grid projected by the
    two homographies — a geometric, scale-aware difference measure."""
    h, w = frame_hw
    xs = np.linspace(0.1 * w, 0.9 * w, 4)
    ys = np.linspace(0.1 * h, 0.9 * h, 3)
    grid = np.asarray([(x, y) for y in ys for x in xs])
    return float(np.linalg.norm(project(h1, grid) - project(h2, grid), axis=1).mean())


class HomographyStabilizer:
    def __init__(
        self,
        smoothing: float = 0.15,
        jump_threshold: float = 10.0,   # rink ft of mean displacement
        jump_persistence: int = 5,      # frames before accepting a cut
        frame_hw=(1080, 1920),
        fine_ttl: int = 30,             # frames a fine lock outlives fine fits
    ):
        self.alpha = smoothing
        self.jump_threshold = jump_threshold
        self.jump_persistence = jump_persistence
        self.frame_hw = frame_hw
        self.fine_ttl = fine_ttl
        self.current: Optional[np.ndarray] = None
        self.current_tier: Optional[str] = None
        self.locked = False
        self._jump_candidate: Optional[np.ndarray] = None
        self._jump_count = 0
        self._fine_age = 0  # frames since the fine estimate was confirmed

    def update(self, h: Optional[np.ndarray],
               tier: str = "fine") -> Optional[np.ndarray]:
        """Feed this frame's raw homography (or None) with its quality
        tier; returns the stabilized estimate."""
        if self.locked or h is None:
            if h is None and self.current_tier == "fine":
                self._fine_age += 1
            return self.current
        h = _normalize(np.asarray(h, np.float64))
        if self.current is None:
            self.current = h
            self.current_tier = tier
            self._fine_age = 0
            return self.current
        if tier == "coarse" and self.current_tier == "fine":
            # a coarse fit never displaces a live fine calibration; only
            # when fine confirmations stop (camera cut into a view where
            # just coarse fits are achievable) does it become eligible
            self._fine_age += 1
            if self._fine_age <= self.fine_ttl:
                return self.current
            self.current_tier = "coarse"  # fine lock expired
        if tier == "fine" and self.current_tier == "coarse":
            # first fine evidence replaces a coarse estimate outright —
            # EMA-blending strictly better data into a worse estimate
            # would just delay convergence
            self.current = h
            self.current_tier = "fine"
            self._fine_age = 0
            self._jump_candidate = None
            self._jump_count = 0
            return self.current
        dist = homography_distance(self.current, h, self.frame_hw)
        if dist > self.jump_threshold:
            # possible camera cut: require persistence before switching
            if (self._jump_candidate is not None
                    and homography_distance(self._jump_candidate, h, self.frame_hw)
                    < self.jump_threshold):
                self._jump_count += 1
            else:
                self._jump_candidate = h
                self._jump_count = 1
            if self._jump_count >= self.jump_persistence:
                self.current = h
                self.current_tier = tier
                self._fine_age = 0 if tier == "fine" else self._fine_age
                self._jump_candidate = None
                self._jump_count = 0
            return self.current
        self._jump_candidate = None
        self._jump_count = 0
        self.current = _normalize((1 - self.alpha) * self.current + self.alpha * h)
        if tier == "fine":
            self.current_tier = "fine"
            self._fine_age = 0
        return self.current

    def lock(self, value: bool = True) -> None:
        self.locked = value

    def reset(self) -> None:
        self.current = None
        self.current_tier = None
        self.locked = False
        self._jump_candidate = None
        self._jump_count = 0
        self._fine_age = 0
