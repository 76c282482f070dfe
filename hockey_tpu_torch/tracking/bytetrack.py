"""Host ByteTrack: port of hockey_tpu/tracking/bytetrack.py (`ByteTrack`
with `from_config`, `_assign` and `_apply_duplicate_kills`).

The reference tracker (`sv.ByteTrack`, hockey/main.py:162-168) with the
same parameter semantics:

- detections split at `track_activation_threshold` into high/low bands
  (low band floor 0.1, per the ByteTrack paper);
- stage 1: all active+lost tracks vs high detections, IoU-distance
  Hungarian assignment gated at `minimum_matching_threshold`;
- stage 2: still-unmatched *active* tracks vs low detections, gate 0.5;
- unmatched high detections start tentative tracks that are emitted only
  after `minimum_consecutive_frames` consecutive hits;
- lost tracks are dropped after `lost_track_buffer * frame_rate / 30`
  frames;
- the duplicate-kill knobs of the device tracker.

The IoU and the assignment go through the host runtime
(tracking/native.py, csrc/hockey_host.cpp), as the JAX package's do: its
Jonker-Volgenant solver picks the same optimum as the JAX package's where
costs tie, which scipy's Hungarian does not.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..core.config import Config
from . import native
from .kalman import BatchKalmanXYAH, xyah_to_xyxy, xyxy_to_xyah

_TRACKED, _LOST, _REMOVED = 0, 1, 2


@dataclasses.dataclass
class _Track:
    track_id: int
    mean: np.ndarray          # (8,)
    cov: np.ndarray           # (8, 8)
    score: float
    class_id: int
    state: int = _TRACKED
    consecutive: int = 1
    activated: bool = False   # emitted at least once
    time_since_update: int = 0

    @property
    def xyxy(self) -> np.ndarray:
        return xyah_to_xyxy(self.mean[None, :4])[0]


# IoU matrix from the host runtime (csrc/hockey_host.cpp); microseconds
# at tracker scale (N <= ~30)
_iou_matrix = native.iou_matrix


def _assign(cost: np.ndarray, gate: float) -> Tuple[List[Tuple[int, int]], List[int], List[int]]:
    """Linear sum assignment with gating. Returns (matches, unmatched_rows,
    unmatched_cols). cost = 1 - IoU; pairs with cost > gate are rejected."""
    if cost.size == 0:
        return [], list(range(cost.shape[0])), list(range(cost.shape[1]))
    rows, cols = native.linear_sum_assignment(cost)
    matches, ur, uc = [], set(range(cost.shape[0])), set(range(cost.shape[1]))
    for r, c in zip(rows, cols):
        if cost[r, c] <= gate:
            matches.append((r, c))
            ur.discard(r)
            uc.discard(c)
    return matches, sorted(ur), sorted(uc)


class ByteTrack:
    """Drop-in behavioral equivalent of the reference's tracker."""

    def __init__(
        self,
        track_activation_threshold: float = 0.25,
        lost_track_buffer: int = 30,
        minimum_matching_threshold: float = 0.8,
        frame_rate: int = 30,
        minimum_consecutive_frames: int = 2,
        duplicate_kill_iomin: float = 0.0,
        lost_dup_kill_iomin: float = 0.0,
    ):
        self.activation_thresh = track_activation_threshold
        self.match_thresh = minimum_matching_threshold
        self.min_consecutive = minimum_consecutive_frames
        self.max_time_lost = int(frame_rate / 30.0 * lost_track_buffer)
        # duplicate-track suppression, parity with the device tracker
        # (COMPAT #27/#29): torso/full-body extent flicker sustains two
        # tracks per actor whose emitted id alternates. 0 = stock
        # ByteTrack. from_config threads the Config defaults (0.55) so
        # the host fallback path matches the fused device path.
        self.dup_kill_iomin = duplicate_kill_iomin
        self.lost_dup_kill_iomin = lost_dup_kill_iomin
        self.kf = BatchKalmanXYAH()
        self.tracks: List[_Track] = []
        self._next_id = 1
        self.frame_id = 0
        # indices into the last update()'s input detections for each
        # returned row (lets callers join per-detection side data, e.g.
        # megastep team features, back onto tracked outputs)
        self.last_indices = np.zeros(0, np.int32)

    @classmethod
    def from_config(cls, config: Config, **overrides) -> "ByteTrack":
        kw = dict(
            track_activation_threshold=config.track_activation_threshold,
            lost_track_buffer=config.lost_track_buffer,
            minimum_matching_threshold=config.minimum_matching_threshold,
            frame_rate=config.frame_rate,
            minimum_consecutive_frames=config.minimum_consecutive_frames,
            duplicate_kill_iomin=config.duplicate_kill_iomin,
            lost_dup_kill_iomin=config.lost_dup_kill_iomin,
        )
        kw.update(overrides)
        return cls(**kw)

    def reset(self) -> None:
        self.tracks = []
        self._next_id = 1
        self.frame_id = 0

    # ------------------------------------------------------------------
    def update(
        self,
        boxes: np.ndarray,
        scores: np.ndarray,
        classes: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """One frame step.

        Returns (boxes, scores, classes, tracker_ids) for detections matched
        to *emittable* tracks — mirroring sv.ByteTrack.update_with_detections
        which returns the input detections that acquired a tracker_id.
        """
        self.frame_id += 1
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        scores = np.asarray(scores, np.float32).reshape(-1)
        classes = (
            np.zeros(len(boxes), np.int32)
            if classes is None
            else np.asarray(classes, np.int32).reshape(-1)
        )

        high = scores >= self.activation_thresh
        low = (scores >= 0.1) & ~high
        det_idx_high = np.flatnonzero(high)
        det_idx_low = np.flatnonzero(low)

        # --- vectorized KF predict over the whole live track table
        live = [t for t in self.tracks if t.state != _REMOVED]
        if live:
            means = np.stack([t.mean for t in live])
            covs = np.stack([t.cov for t in live])
            means, covs = self.kf.predict(means, covs)
            for t, m, c in zip(live, means, covs):
                t.mean, t.cov = m, c
                t.time_since_update += 1

        active = [t for t in live if t.state == _TRACKED]
        lost = [t for t in live if t.state == _LOST]

        # --- stage 1: active+lost vs high-score detections
        pool = active + lost
        pool_boxes = np.stack([t.xyxy for t in pool]) if pool else np.zeros((0, 4), np.float32)
        cost = 1.0 - _iou_matrix(pool_boxes, boxes[det_idx_high])
        matches, un_tracks, un_dets = _assign(cost, self.match_thresh)

        out: List[Tuple[_Track, int]] = []  # (track, detection index)
        matched_means, matched_covs, matched_meas, matched_tracks = [], [], [], []
        for ti, di in matches:
            t, d = pool[ti], int(det_idx_high[di])
            matched_tracks.append((t, d))
            matched_means.append(t.mean)
            matched_covs.append(t.cov)
            matched_meas.append(xyxy_to_xyah(boxes[d : d + 1])[0])
        if matched_tracks:
            mm, cc = self.kf.update(
                np.stack(matched_means), np.stack(matched_covs), np.stack(matched_meas)
            )
            for (t, d), m, c in zip(matched_tracks, mm, cc):
                was_lost = t.state == _LOST
                t.mean, t.cov = m, c
                t.score = float(scores[d])
                t.class_id = int(classes[d])
                t.consecutive = 1 if was_lost else t.consecutive + 1
                t.state = _TRACKED
                t.time_since_update = 0
                if t.consecutive >= self.min_consecutive or t.activated:
                    t.activated = True
                    out.append((t, d))

        # --- stage 2: remaining *active* tracks vs low-score detections
        rem_active = [pool[i] for i in un_tracks if pool[i].state == _TRACKED]
        if rem_active and len(det_idx_low):
            ra_boxes = np.stack([t.xyxy for t in rem_active])
            cost2 = 1.0 - _iou_matrix(ra_boxes, boxes[det_idx_low])
            m2, un2, _ = _assign(cost2, 0.5)
            meas2, mt2 = [], []
            for ti, di in m2:
                t, d = rem_active[ti], int(det_idx_low[di])
                mt2.append((t, d))
                meas2.append(xyxy_to_xyah(boxes[d : d + 1])[0])
            if mt2:
                mm, cc = self.kf.update(
                    np.stack([t.mean for t, _ in mt2]),
                    np.stack([t.cov for t, _ in mt2]),
                    np.stack(meas2),
                )
                for (t, d), m, c in zip(mt2, mm, cc):
                    t.mean, t.cov = m, c
                    t.score = float(scores[d])
                    t.consecutive += 1
                    t.time_since_update = 0
                    if t.activated or t.consecutive >= self.min_consecutive:
                        t.activated = True
                        out.append((t, d))
            lost_after2 = [rem_active[i] for i in un2]
        else:
            lost_after2 = rem_active

        # --- unmatched active tracks become lost
        for t in lost_after2:
            t.state = _LOST
            t.consecutive = 0

        # --- expire stale lost tracks
        for t in self.tracks:
            if t.state == _LOST and t.time_since_update > self.max_time_lost:
                t.state = _REMOVED
        self.tracks = [t for t in self.tracks if t.state != _REMOVED]

        # --- new tracks from unmatched high detections
        for di in un_dets:
            d = int(det_idx_high[di])
            mean, cov = self.kf.initiate(xyxy_to_xyah(boxes[d : d + 1]))
            t = _Track(
                track_id=self._next_id,
                mean=mean[0],
                cov=cov[0],
                score=float(scores[d]),
                class_id=int(classes[d]),
            )
            self._next_id += 1
            self.tracks.append(t)
            if self.min_consecutive <= 1:
                t.activated = True
                out.append((t, d))

        # --- duplicate-track suppression (device-tracker parity,
        # COMPAT #27/#29): run after new-track creation, before emission,
        # exactly like tracking/device_tracker.py tracker_step
        dead = self._apply_duplicate_kills()
        if dead:
            out = [(t, d) for t, d in out if t.track_id not in dead]

        if not out:
            z4 = np.zeros((0, 4), np.float32)
            z = np.zeros((0,), np.float32)
            self.last_indices = np.zeros(0, np.int32)
            return z4, z, z.astype(np.int32), z.astype(np.int32)

        out.sort(key=lambda td: td[1])
        idx = np.asarray([d for _, d in out], np.int32)
        ids = np.asarray([t.track_id for t, _ in out], np.int32)
        self.last_indices = idx
        return boxes[idx], scores[idx], classes[idx], ids

    def _apply_duplicate_kills(self) -> set:
        """Kill duplicate tracks per the device-tracker semantics
        (tracking/device_tracker.py tracker_step, COMPAT #27/#29):

        - duplicate_kill_iomin: a TRACKED track dies when it overlaps an
          OLDER (smaller-id) TRACKED same-class track at
          intersection-over-min-area above the threshold;
        - lost_dup_kill_iomin: a LOST track dies when its predicted box
          is covered by a TRACKED older same-class track — the measured
          OOD alternation mode (one extent tracked, one lost per frame).

        Returns the set of killed track ids so the caller can drop them
        from this frame's emission (device parity: emit is computed
        after the kills)."""
        if self.dup_kill_iomin <= 0 and self.lost_dup_kill_iomin <= 0:
            return set()
        live = [t for t in self.tracks if t.state != _REMOVED]
        if len(live) < 2:
            return set()
        b = np.stack([t.xyxy for t in live])
        tl = np.maximum(b[:, None, :2], b[None, :, :2])
        br = np.minimum(b[:, None, 2:], b[None, :, 2:])
        inter = np.prod(np.clip(br - tl, 0.0, None), -1)
        area = np.prod(np.clip(b[:, 2:] - b[:, :2], 0.0, None), -1)
        iomin = inter / np.maximum(
            np.minimum(area[:, None], area[None, :]), 1e-9)
        ids = np.asarray([t.track_id for t in live])
        cls = np.asarray([t.class_id for t in live])
        st = np.asarray([t.state for t in live])
        younger = ids[None, :] < ids[:, None]  # row i younger than col j
        same = cls[:, None] == cls[None, :]
        tracked = st == _TRACKED
        killed = np.zeros(len(live), bool)
        if self.dup_kill_iomin > 0:
            killed |= ((iomin > self.dup_kill_iomin) & younger
                       & tracked[:, None] & tracked[None, :] & same).any(1)
        if self.lost_dup_kill_iomin > 0:
            lost = st == _LOST
            killed |= ((iomin > self.lost_dup_kill_iomin) & younger
                       & lost[:, None] & tracked[None, :] & same).any(1)
        if not killed.any():
            return set()
        dead = {int(ids[i]) for i in np.flatnonzero(killed)}
        for t in live:
            if t.track_id in dead:
                t.state = _REMOVED
        self.tracks = [t for t in self.tracks if t.state != _REMOVED]
        return dead
