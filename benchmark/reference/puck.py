"""The plain reference of the puck tracker: a frozen copy of the
program's PuckTracker (gated selection, a recency-weighted linear fit,
coasting and re-acquisition), numpy on the host, without its drawing.
Nothing here imports the program.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import numpy as np


class PuckTracker:
    """Detection history, trajectory smoothing and a fading trail; numpy on
    the host (hockey_tpu sahi.py:124-355). The gating constants are the
    JAX package's, from its operating-point sweep with the shipped puck
    model (scripts/sweep_puck_gate.py, COMPAT.md #31)."""

    GATE_BASE = 28.0    # lock gate radius around the predicted position
    GATE_VEL = 3.0      # gate growth per px/frame of estimated speed
    GATE_MISS = 6.0     # gate growth per coasted (missed) frame
    PEND_RADIUS = 48.0  # spatial consistency radius for pending evidence
    PEND_SNAP = 2       # consecutive consistent far fires to re-acquire
    PEND_MARGIN = 0.10  # score margin a far fire needs over the gated pick
    COAST_FRAMES = 5    # misses for which the extrapolated position is
                        # still emitted (the state lives to max_gap)

    def __init__(self, trail_length: int = 30, smooth_window: int = 5,
                 max_gap: int = 15):
        self.trail: deque = deque(maxlen=trail_length)
        self.history: deque = deque(maxlen=smooth_window)
        self._ts: deque = deque(maxlen=smooth_window)  # frame stamps
        self._t = 0
        self.max_gap = max_gap
        self.misses = 0
        self._vel = np.zeros(2, np.float32)   # px/frame, EMA-smoothed
        self._last: Optional[np.ndarray] = None
        self._pend: Optional[np.ndarray] = None  # candidate re-acquisition
        self._pend_n = 0

    def _note_pending(self, c: np.ndarray) -> bool:
        """Accumulate spatially consistent off-track evidence; True once
        PEND_SNAP consecutive consistent fires have been seen."""
        if (self._pend is not None
                and float(np.linalg.norm(c - self._pend)) <= self.PEND_RADIUS):
            self._pend = 0.5 * (self._pend + c)
            self._pend_n += 1
        else:
            self._pend = c.copy()
            self._pend_n = 1
        return self._pend_n >= self.PEND_SNAP

    def _clear_pending(self) -> None:
        self._pend = None
        self._pend_n = 0

    def _reacquire(self, c: np.ndarray) -> Optional[Tuple[float, float]]:
        """Drop the stale track state and restart the fit at c."""
        self.history.clear()
        self._ts.clear()
        self._vel = np.zeros(2, np.float32)
        self._last = None
        self.misses = 0
        self._clear_pending()
        return self.update((float(c[0]), float(c[1])))

    def ingest(self, boxes: np.ndarray, scores: np.ndarray
               ) -> Tuple[Optional[Tuple[float, float]], Optional[int]]:
        """Gated selection over this frame's detections, then `update`.
        While locked, only detections inside a velocity-scaled gate around
        the predicted position are eligible (best score minus distance);
        a fire off the gate, or any fire while unlocked, takes over only
        after PEND_SNAP consecutive consistent frames. Returns (smoothed
        position, index of the selected detection or None)."""
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        scores = np.asarray(scores, np.float32).reshape(-1)
        if boxes.shape[0] == 0:
            return self.update(None), None
        cents = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2,
                          (boxes[:, 1] + boxes[:, 3]) / 2], 1)

        if self._last is None:
            i = int(np.argmax(scores))
            if self._note_pending(cents[i]):
                return self._reacquire(cents[i]), i
            self.update(None)
            return None, None

        gate = (self.GATE_BASE
                + self.GATE_VEL * float(np.linalg.norm(self._vel))
                + self.GATE_MISS * self.misses)
        d = np.linalg.norm(cents - self._last, axis=1)
        in_gate = d <= gate
        if in_gate.any():
            util = np.where(in_gate, scores - 0.004 * d, -np.inf)
            i = int(np.argmax(util))
            # a much more confident fire far away: if it persists, it is
            # the puck and the lock is on a distractor
            far = (~in_gate) & (scores > scores[i] + self.PEND_MARGIN)
            if far.any():
                j = int(np.argmax(np.where(far, scores, -np.inf)))
                if self._note_pending(cents[j]):
                    return self._reacquire(cents[j]), j
            else:
                self._clear_pending()
            return self.update((float(cents[i, 0]), float(cents[i, 1]))), i
        # nothing in the gate: coast, with the best fire as pending evidence
        j = int(np.argmax(scores))
        if self._note_pending(cents[j]):
            return self._reacquire(cents[j]), j
        return self.update(None), None

    def update(self, center: Optional[Tuple[float, float]]
               ) -> Optional[Tuple[float, float]]:
        """Feed this frame's puck centre (or None); returns the smoothed
        position. Short gaps extrapolate at the damped estimated velocity."""
        self._t += 1                 # frame clock (misses advance it too)
        if center is None:
            self.misses += 1
            if self.misses > self.max_gap:
                self.history.clear()
                self._ts.clear()
                self._last = None
                self._vel = np.zeros(2, np.float32)
                return None
            if self._last is not None:
                self._last = self._last + self._vel
                self._vel = self._vel * 0.92
                if self.misses > self.COAST_FRAMES:
                    return None  # state kept for gating, output suppressed
                self.trail.append((float(self._last[0]),
                                   float(self._last[1])))
                return (float(self._last[0]), float(self._last[1]))
            return None
        c = np.asarray(center, np.float32)
        if (self.misses > 2 and self._last is not None
                and float(np.linalg.norm(c - self._last)) > 32.0):
            # re-acquired after a gap far from the extrapolation: snap to
            # the new evidence instead of dragging stale history
            self.history.clear()
            self._ts.clear()
            self._vel = np.zeros(2, np.float32)
        self.misses = 0
        self.history.append(c)
        self._ts.append(self._t)
        sm = self.smoothed()
        if sm is not None:
            smv = np.asarray(sm, np.float32)
            if self._last is not None:
                self._vel = 0.35 * self._vel + 0.65 * (smv - self._last)
            self._last = smv
            self.trail.append(sm)
        return sm

    def smoothed(self) -> Optional[Tuple[float, float]]:
        """Recency-weighted linear fit over the history window, evaluated
        at the newest sample's frame (no lag on constant-velocity motion)."""
        n = len(self.history)
        if n == 0:
            return None
        pts = np.stack(list(self.history))
        if n < 3:
            p = pts[-1] if n == 1 else pts.mean(0) * 0.5 + pts[-1] * 0.5
            return (float(p[0]), float(p[1]))
        t = np.asarray(list(self._ts), np.float32)
        t = t - t[-1]                       # newest sample at t=0
        w = 1.0 / (1.0 + 0.35 * (-t))       # recency weighting
        sw = w.sum()
        tm = (w * t).sum() / sw
        den = (w * (t - tm) ** 2).sum()
        p = np.empty(2, np.float32)
        for d in range(2):
            ym = (w * pts[:, d]).sum() / sw
            b = ((w * (t - tm) * (pts[:, d] - ym)).sum() / den
                 if den > 1e-6 else 0.0)
            p[d] = ym + b * (0.0 - tm)       # evaluate at the newest frame
        return (float(p[0]), float(p[1]))
