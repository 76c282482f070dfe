"""Display-time bounding-box stabilizers, vectorized over all tracks:
the port's numpy copy of hockey_tpu/annotate/stabilizers.py
(`hysteresis_round`, `EmaStabilizer`, `AdaptiveStabilizer`,
`KalmanStabilizer`, `make_stabilizer`).

Behavioral parity targets (reference, per-track Python loops):
- AdaptiveStabilizer  == hockey/common/adaptive_size_stabilizer.py:11-206
- KalmanStabilizer    == hockey/common/detection_stabilizer.py:10-212
- EmaStabilizer       == the EMA fallbacks (detection_stabilizer.py:105-119,
  detection_stabilizer_v2.py:63-78)

They smooth *display* boxes only: the detections and the tracker state
are never modified.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np


def hysteresis_round(vals: np.ndarray) -> np.ndarray:
    """Jitter-resistant rounding (reference detection_stabilizer.py:164-180):
    fractional part > 0.8 rounds up, < 0.2 truncates, else standard round."""
    int_part = np.trunc(vals)
    frac = vals - int_part
    up = int_part + 1
    std = np.round(vals)
    out = np.where(frac > 0.8, up, np.where(frac < 0.2, int_part, std))
    return out


class _TrackTable:
    """id -> slot mapping over preallocated state arrays."""

    def __init__(self):
        self.slots: Dict[int, int] = {}

    def lookup(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (slot_or_minus1 per id, is_new mask)."""
        out = np.full(len(ids), -1, np.int64)
        for i, tid in enumerate(ids):
            out[i] = self.slots.get(int(tid), -1)
        return out, out < 0

    def assign(self, tid: int, slot: int) -> None:
        self.slots[int(tid)] = slot

    def retain(self, active: Iterable[int]) -> None:
        active = {int(a) for a in active}
        self.slots = {k: v for k, v in self.slots.items() if k in active}


class EmaStabilizer:
    """Plain per-track EMA on xyxy (reference _update_ema / _simple_smooth)."""

    def __init__(self, smoothing_factor: float = 0.3, hysteresis: bool = False):
        self.alpha = smoothing_factor
        self.hysteresis = hysteresis
        self.state: Dict[int, np.ndarray] = {}

    def update_batch(self, ids, boxes, confidences=None) -> np.ndarray:
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        out = np.empty_like(boxes)
        for i, tid in enumerate(ids):
            tid = int(tid)
            prev = self.state.get(tid)
            if prev is None:
                sm = boxes[i]
            else:
                sm = self.alpha * boxes[i] + (1 - self.alpha) * prev
            self.state[tid] = sm
            out[i] = sm
        return hysteresis_round(out) if self.hysteresis else np.round(out)

    def cleanup(self, active_ids) -> None:
        active = {int(a) for a in active_ids}
        self.state = {k: v for k, v in self.state.items() if k in active}

    def reset(self) -> None:
        self.state.clear()


def _row_percentiles(vals, valid, hl, qs):
    """Per-row linear-interpolated percentiles over each row's valid tail
    (np.percentile semantics), vectorized: invalid entries sort to the
    end as +inf and indices 0..hl-1 are the valid sorted values.
    np.nanpercentile does the same but at ~10x the cost for small rows."""
    tmp = np.where(valid, vals.astype(np.float64), np.inf)
    srt = np.sort(tmp, axis=1)
    rows = np.arange(len(hl))
    out = []
    for q in qs:
        pos = (q / 100.0) * (hl - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.ceil(pos).astype(np.int64)
        frac = pos - lo
        out.append(srt[rows, lo] * (1 - frac) + srt[rows, hi] * frac)
    return out


class AdaptiveStabilizer:
    """Motion-aware position/size smoothing, vectorized.

    Semantics (adaptive_size_stabilizer.py):
      position EMA: alpha_p = position_smoothing * conf
      size EMA:     alpha_s = (base + min(v/motion_thr, 1) * 0.2) * conf,
                    halved when current size falls inside the IQR of the
                    last `window` sizes (>= 5 samples)
      aspect clamp: if |ar - median_ar|/median_ar > tol, snap to the median
                    aspect preserving area, blended 70/30 toward the fix
      new tracks:   pass through unchanged
      velocity:     distance from the *smoothed* previous center
    """

    WINDOW = 15

    def __init__(
        self,
        position_smoothing: float = 0.3,
        size_smoothing_base: float = 0.1,
        motion_threshold: float = 10.0,
        aspect_ratio_tolerance: float = 0.2,
    ):
        self.pos_alpha = position_smoothing
        self.size_base = size_smoothing_base
        self.motion_thr = motion_threshold
        self.ar_tol = aspect_ratio_tolerance
        self._table = _TrackTable()
        cap = 0
        self.smooth_pos = np.zeros((cap, 2), np.float32)
        self.smooth_size = np.zeros((cap, 2), np.float32)
        self.size_hist = np.zeros((cap, self.WINDOW, 2), np.float32)
        self.ar_hist = np.zeros((cap, self.WINDOW), np.float32)
        self.hist_len = np.zeros((cap,), np.int64)
        self._free: list[int] = []

    def _grow(self, n: int) -> None:
        cap = len(self.hist_len)
        new = max(16, n)
        self.smooth_pos = np.concatenate([self.smooth_pos, np.zeros((new, 2), np.float32)])
        self.smooth_size = np.concatenate([self.smooth_size, np.zeros((new, 2), np.float32)])
        self.size_hist = np.concatenate([self.size_hist, np.zeros((new, self.WINDOW, 2), np.float32)])
        self.ar_hist = np.concatenate([self.ar_hist, np.zeros((new, self.WINDOW), np.float32)])
        self.hist_len = np.concatenate([self.hist_len, np.zeros((new,), np.int64)])
        self._free.extend(range(cap, cap + new))

    def update_batch(self, ids, boxes, confidences=None) -> np.ndarray:
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        n = len(boxes)
        conf = (
            np.ones(n, np.float32)
            if confidences is None
            else np.asarray(confidences, np.float32).reshape(-1)
        )
        cx = (boxes[:, 0] + boxes[:, 2]) / 2
        cy = (boxes[:, 1] + boxes[:, 3]) / 2
        w = boxes[:, 2] - boxes[:, 0]
        h = boxes[:, 3] - boxes[:, 1]
        ar = w / np.maximum(h, 1.0)

        slots, is_new = self._table.lookup(np.asarray(ids))
        # allocate slots for new tracks
        for i in np.flatnonzero(is_new):
            if not self._free:
                self._grow(n)
            s = self._free.pop()
            slots[i] = s
            self._table.assign(int(ids[i]), s)
            self.smooth_pos[s] = (cx[i], cy[i])
            self.smooth_size[s] = (w[i], h[i])
            self.hist_len[s] = 0
            self._push(s, w[i], h[i], ar[i])
            self.hist_len[s] = 1

        out = boxes.copy()
        old = np.flatnonzero(~is_new)
        if len(old) == 0:
            return out
        s = slots[old]

        prev_pos = self.smooth_pos[s]
        prev_size = self.smooth_size[s]
        vel = np.hypot(cx[old] - prev_pos[:, 0], cy[old] - prev_pos[:, 1])

        # push histories — one fancy-indexed shift for all slots (the
        # former per-track np.roll/np.percentile loops cost ~2.2 ms/frame
        # at 12 tracks and were the e2e pipeline's host bound)
        self.size_hist[s] = np.concatenate(
            [self.size_hist[s, 1:], np.stack([w[old], h[old]], 1)[:, None, :]],
            axis=1)
        self.ar_hist[s] = np.concatenate(
            [self.ar_hist[s, 1:], ar[old][:, None]], axis=1)
        self.hist_len[s] = np.minimum(self.hist_len[s] + 1, self.WINDOW)

        # position EMA
        ap = (self.pos_alpha * conf[old])[:, None]
        new_pos = ap * np.stack([cx[old], cy[old]], 1) + (1 - ap) * prev_pos

        # size EMA, motion-aware + IQR damping (percentiles over each
        # track's valid history window, NaN-masked + vectorized)
        motion = np.minimum(vel / self.motion_thr, 1.0)
        a_s = (self.size_base + motion * 0.2) * conf[old]
        hl = self.hist_len[s]
        idx = np.arange(self.WINDOW)[None, :]
        valid = idx >= (self.WINDOW - hl[:, None])
        eligible = hl >= 5
        if eligible.any():
            w25, w75 = _row_percentiles(
                self.size_hist[s, :, 0], valid, hl, (25.0, 75.0))
            h25, h75 = _row_percentiles(
                self.size_hist[s, :, 1], valid, hl, (25.0, 75.0))
            inside = ((w25 <= w[old]) & (w[old] <= w75)
                      & (h25 <= h[old]) & (h[old] <= h75) & eligible)
            a_s = np.where(inside, a_s * 0.5, a_s)
        new_size = a_s[:, None] * np.stack([w[old], h[old]], 1) + (1 - a_s[:, None]) * prev_size

        # aspect-ratio clamp (median over history, area preserved, 70/30 blend)
        if eligible.any():
            (med_ar,) = _row_percentiles(self.ar_hist[s], valid, hl, (50.0,))
            cw, ch = new_size[:, 0], new_size[:, 1]
            cur_ar = cw / np.maximum(ch, 1.0)
            safe = np.where(med_ar > 0, med_ar, 1.0)
            bad = (eligible & (med_ar > 0)
                   & (np.abs(cur_ar - med_ar) / safe > self.ar_tol))
            area = cw * ch
            fh = np.sqrt(area / safe)
            fw = med_ar * fh
            new_size[:, 0] = np.where(bad, 0.7 * fw + 0.3 * cw, cw)
            new_size[:, 1] = np.where(bad, 0.7 * fh + 0.3 * ch, ch)

        self.smooth_pos[s] = new_pos
        self.smooth_size[s] = new_size
        half = new_size / 2
        out[old, 0] = new_pos[:, 0] - half[:, 0]
        out[old, 1] = new_pos[:, 1] - half[:, 1]
        out[old, 2] = new_pos[:, 0] + half[:, 0]
        out[old, 3] = new_pos[:, 1] + half[:, 1]
        return out

    def _push(self, slot: int, w: float, h: float, ar: float) -> None:
        self.size_hist[slot] = np.roll(self.size_hist[slot], -1, axis=0)
        self.size_hist[slot, -1] = (w, h)
        self.ar_hist[slot] = np.roll(self.ar_hist[slot], -1)
        self.ar_hist[slot, -1] = ar

    def cleanup(self, active_ids) -> None:
        gone = [tid for tid in self._table.slots if tid not in {int(a) for a in active_ids}]
        for tid in gone:
            self._free.append(self._table.slots.pop(tid))

    def reset(self) -> None:
        self._free.extend(self._table.slots.values())
        self._table.slots.clear()


class KalmanStabilizer:
    """Kalman-predictive smoothing (reference DetectionStabilizer semantics).

    Filter constants from kalman_tracker.py: state (cx, cy, w, h, +vel),
    F couples position to velocity with dt=1, Q = diag(0.01 x4, 0.1 x4),
    R = 0.1 I / max(conf, 0.1), P0 = 10 I. Adaptive blending from
    detection_stabilizer.py:60-103: less smoothing at high motion
    (> velocity_threshold) and high confidence; median size stabilization
    over a 5-frame window when the deviation is < 15%; hysteresis rounding.
    """

    def __init__(
        self,
        smoothing_factor: float = 0.3,
        velocity_threshold: float = 15.0,
        size_stability_factor: float = 0.4,
    ):
        self.alpha0 = smoothing_factor
        self.vel_thr = velocity_threshold
        self.size_factor = size_stability_factor
        self.means: Dict[int, np.ndarray] = {}
        self.covs: Dict[int, np.ndarray] = {}
        self.size_hist: Dict[int, list] = {}
        self.F = np.eye(8, dtype=np.float32)
        self.F[:4, 4:] = np.eye(4, dtype=np.float32)
        self.Q = np.diag([0.01] * 4 + [0.1] * 4).astype(np.float32)
        self.R = (np.eye(4) * 0.1).astype(np.float32)

    @staticmethod
    def _to_cxcywh(b):
        return np.asarray(
            [(b[0] + b[2]) / 2, (b[1] + b[3]) / 2, b[2] - b[0], b[3] - b[1]],
            np.float32,
        )

    @staticmethod
    def _to_xyxy(st):
        cx, cy, w, h = st[:4]
        w, h = max(w, 1.0), max(h, 1.0)
        return np.asarray([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], np.float32)

    def update_batch(self, ids, boxes, confidences=None) -> np.ndarray:
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        n = len(boxes)
        conf = (
            np.ones(n, np.float32)
            if confidences is None
            else np.asarray(confidences, np.float32).reshape(-1)
        )
        out = np.empty_like(boxes)
        for i, tid in enumerate(ids):
            tid = int(tid)
            if tid not in self.means:
                z = self._to_cxcywh(boxes[i])
                self.means[tid] = np.concatenate([z, np.zeros(4, np.float32)])
                self.covs[tid] = np.eye(8, dtype=np.float32) * 10.0
                self.size_hist[tid] = []
                out[i] = boxes[i]
                continue
            m, P = self.means[tid], self.covs[tid]
            # predict
            m = self.F @ m
            P = self.F @ P @ self.F.T + self.Q
            predicted = self._to_xyxy(m)
            # adaptive smoothing factor from motion + confidence
            motion = float(np.hypot(m[4], m[5]))
            if motion > self.vel_thr:
                mf = min(motion / (self.vel_thr * 2), 1.0)
                alpha = self.alpha0 * (1 - mf * 0.7)
            else:
                alpha = self.alpha0
            alpha = float(np.clip(alpha * (2.0 - conf[i]), 0.1, 0.9))
            blended = (1 - alpha) * predicted + alpha * boxes[i]
            # measurement update with confidence-adaptive R
            z = self._to_cxcywh(blended)
            Ra = self.R / max(conf[i], 0.1)
            S = P[:4, :4] + Ra
            K = P[:, :4] @ np.linalg.inv(S)
            m = m + K @ (z - m[:4])
            P = P - K @ P[:4, :]
            self.means[tid], self.covs[tid] = m, P
            sm = self._to_xyxy(m)
            out[i] = self._stabilize_size(tid, sm)
        return hysteresis_round(out)

    def _stabilize_size(self, tid: int, bbox: np.ndarray) -> np.ndarray:
        w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
        hist = self.size_hist[tid]
        hist.append((w, h))
        if len(hist) > 5:
            hist.pop(0)
        if len(hist) >= 3:
            sizes = np.asarray(hist)
            mw, mh = np.median(sizes[:, 0]), np.median(sizes[:, 1])
            if abs(w - mw) / mw < 0.15 and abs(h - mh) / mh < 0.15:
                sw = w * (1 - self.size_factor) + mw * self.size_factor
                sh = h * (1 - self.size_factor) + mh * self.size_factor
                cx, cy = (bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2
                return np.asarray(
                    [cx - sw / 2, cy - sh / 2, cx + sw / 2, cy + sh / 2], np.float32
                )
        return bbox

    def cleanup(self, active_ids) -> None:
        active = {int(a) for a in active_ids}
        for d in (self.means, self.covs, self.size_hist):
            for k in [k for k in d if k not in active]:
                del d[k]

    def reset(self) -> None:
        self.means.clear()
        self.covs.clear()
        self.size_hist.clear()


def make_stabilizer(smoothing_factor: float = 0.3, use_adaptive: bool = True):
    """Stabilizer selection as wired by the reference SmoothAnnotator
    (smooth_annotator.py:26-41): adaptive V2 (position 0.4 / size 0.1) when
    use_adaptive, else Kalman V1 (velocity_threshold 15, size factor 0.4)."""
    if use_adaptive:
        return AdaptiveStabilizer(
            position_smoothing=0.4,
            size_smoothing_base=0.1,
            motion_threshold=10.0,
            aspect_ratio_tolerance=0.2,
        )
    return KalmanStabilizer(
        smoothing_factor=smoothing_factor,
        velocity_threshold=15.0,
        size_stability_factor=0.4,
    )
