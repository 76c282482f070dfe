"""Sliced puck detection: port of hockey_tpu/slicing/sahi.py
(`slice_grid`, `SlicedDetector`, `PuckTracker`, `demote_in_player_boxes`,
`PuckPipeline`).

The puck model (YOLOv8s, one class) runs on overlapping square tiles of
the frame, which the slice grid fixes for a frame size. A batch of K
frames crosses to the device once; the K x T tiles are cut there and go
through one forward with per-tile NMS (the suppression kernel, B = K x T);
one merge per batch shifts the tiles' boxes to frame coordinates and runs
class-aware NMS per frame (the kernel again, B = K) down to 4 boxes. The
host keeps the tracker: gated selection, a recency-weighted linear fit
and a fading trail. OpenCV is imported only to draw.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import Config
from ..core.staging import upload
from ..models.detector import Detector, fetch, pack
from ..ops.nms import Candidates, Detections, nms_candidates, nms_select
from ..ops.nms_kernel import suppress
from ..utils.profiling import annotate

# the merge: IoU threshold, candidates per frame at most, boxes kept
# (hockey_tpu sahi.py:80-101); each tile keeps at most TILE_MAX_DET
MERGE_IOU, MERGE_TOPK, MERGE_MAX_DET, TILE_MAX_DET = 0.5, 64, 4, 8


def slice_grid(h: int, w: int, size: int, overlap: float) -> List[Tuple[int, int]]:
    """Top-left (y, x) offsets of the overlapping size x size tiles that
    cover (h, w): stride size * (1 - overlap), the last tile flush with
    the edge."""
    stride = max(int(size * (1.0 - overlap)), 1)

    def starts(total):
        if total <= size:
            return [0]
        s = list(range(0, total - size, stride))
        s.append(total - size)
        return s

    return [(y, x) for y in starts(h) for x in starts(w)]


class SlicedDetector:
    """Tiled inference of the puck model over frame batches."""

    def __init__(self, config: Config, frame_hw: Tuple[int, int],
                 checkpoint: Optional[str] = None, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        self.config = config
        self.h, self.w = frame_hw
        # a frame smaller than the configured tile shrinks the tile to fit
        self.size = min(config.puck_slice_size, self.h, self.w)
        self.grid = slice_grid(self.h, self.w, self.size,
                               config.puck_slice_overlap)
        self.detector = Detector(
            config.puck_model_name, config, frame_hw=(self.size, self.size),
            imgsz=self.size, conf=config.puck_confidence,
            checkpoint=checkpoint, max_det=TILE_MAX_DET, device=device,
            dtype=dtype)
        self.device = self.detector.device
        self.offsets = torch.tensor([(x, y, x, y) for y, x in self.grid],
                                    dtype=torch.float32, device=self.device)

    def tiles(self, frames: torch.Tensor) -> torch.Tensor:
        """(K, H, W, 3) on the device -> (K * T, S, S, 3), frame-major."""
        s = self.size
        return torch.stack([frames[:, y:y + s, x:x + s] for y, x in self.grid],
                           dim=1).reshape(-1, s, s, frames.shape[-1])

    def merge_candidates(self, det: Detections) -> Candidates:
        """The tiles' detections (K * T, d) -> each frame's merge
        candidates: boxes shifted to frame coordinates, invalid slots at
        score -1, the top min(64, T * d) by score and their IoU matrix."""
        t = len(self.grid)
        k, d = det.boxes.shape[0] // t, det.boxes.shape[1]
        boxes = (det.boxes.reshape(k, t, d, 4)
                 + self.offsets[None, :, None, :]).reshape(k, t * d, 4)
        scores = torch.where(det.valid, det.scores, -1.0).reshape(k, t * d)
        return nms_candidates(
            boxes, scores, det.classes.reshape(k, t * d),
            score_threshold=self.config.puck_confidence,
            iou_threshold=MERGE_IOU, pre_topk=min(MERGE_TOPK, t * d))

    def merge(self, det: Detections) -> Detections:
        """Cross-tile NMS per frame: (K, 4) detections in frame pixels."""
        c = self.merge_candidates(det)
        keep = suppress(c.matrix, c.keep0, c.thr)
        return nms_select(c, keep, score_threshold=self.config.puck_confidence,
                          max_det=MERGE_MAX_DET)

    def detect_frames(self, frames) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(K, H, W, 3) uint8 frames -> (boxes (K, 4, 4), scores (K, 4),
        valid (K, 4)) on the host: one upload, the tiles cut on the device,
        one forward with per-tile NMS (the tile `Detector`'s step), one
        merge, one copy back (`pack`, `fetch`)."""
        x = upload(frames, self.device)
        with torch.inference_mode():
            with annotate("slice"):
                tiles = self.tiles(x)
            det = self.detector.step(tiles)
            with annotate("merge"):
                m = self.merge(det)
            packed = pack(m)
        host = fetch(packed)
        return host.boxes, host.scores, host.valid

    def detect(self, frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(H, W, 3) -> (boxes (n, 4), scores (n,)) in frame pixels."""
        boxes, scores, valid = self.detect_frames(frame[None])
        return boxes[0][valid[0]], scores[0][valid[0]]


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

    def draw_trail(self, frame: np.ndarray,
                   color: Tuple[int, int, int] = (0, 215, 255)) -> np.ndarray:
        import cv2

        pts = list(self.trail)
        for i in range(1, len(pts)):
            alpha = i / len(pts)
            c = tuple(int(v * alpha) for v in color)
            cv2.line(frame, (int(pts[i - 1][0]), int(pts[i - 1][1])),
                     (int(pts[i][0]), int(pts[i][1])), c, 2)
        if pts:
            cv2.circle(frame, (int(pts[-1][0]), int(pts[-1][1])), 6, color, -1)
        return frame


def demote_in_player_boxes(puck_boxes: np.ndarray, puck_scores: np.ndarray,
                           player_boxes: np.ndarray,
                           player_valid: np.ndarray,
                           factor: float, foot_band: float = 0.2
                           ) -> np.ndarray:
    """Multiply by `factor` the score of each puck candidate whose centre
    lies inside a player box above the box's bottom `foot_band` fraction
    (a glove at mid-body height; a puck by a player sits at skate level).
    Arrays (K, n, 4), (K, n), (K, D, 4), (K, D) on the host."""
    out = np.asarray(puck_scores).copy()
    for i in range(len(out)):
        pb = np.asarray(player_boxes[i])[np.asarray(player_valid[i])]
        if not len(pb):
            continue
        b = np.asarray(puck_boxes[i])
        c = (b[:, :2] + b[:, 2:]) / 2.0
        y_cut = pb[:, 3] - foot_band * (pb[:, 3] - pb[:, 1])
        inside = ((c[:, 0:1] >= pb[None, :, 0])
                  & (c[:, 0:1] <= pb[None, :, 2])
                  & (c[:, 1:2] >= pb[None, :, 1])
                  & (c[:, 1:2] <= y_cut[None, :]))
        out[i] = np.where(inside.any(axis=1), out[i] * factor, out[i])
    return out


class PuckPipeline:
    """PUCK_DETECTION: sliced detection, PuckTracker and the trail overlay.
    With 0 < `puck_player_demote` < 1 the player detector runs on the same
    frames and demotes mid-body puck candidates."""

    def __init__(self, config: Config, frame_hw: Tuple[int, int] = (1080, 1920),
                 checkpoint: Optional[str] = None, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        self.config = config
        self.sliced = SlicedDetector(config, frame_hw, checkpoint=checkpoint,
                                     device=device, dtype=dtype)
        self.tracker = PuckTracker(trail_length=config.puck_trail_length)
        self.last_center = None      # the tracker's smoothed position
        self.last_detection = None   # centre of this frame's selected box
        self.player_detector = None
        if 0.0 < config.puck_player_demote < 1.0:
            self.player_detector = Detector(
                config.player_model_name, config, frame_hw=frame_hw,
                device=self.sliced.device, dtype=dtype)

    def detect_frame(self, frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One frame's puck boxes and (demoted) scores (`detect_batch`)."""
        boxes, scores, valid = self.detect_batch(frame[None])
        return boxes[0][valid[0]], scores[0][valid[0]]

    def process_frame(self, frame: np.ndarray) -> np.ndarray:
        return self.annotate(frame, *self.detect_frame(frame))

    def process_batch(self, frames: np.ndarray, n: Optional[int] = None
                      ) -> List[np.ndarray]:
        """(K, H, W, 3) frames through `detect_batch`, then the tracker and
        the drawing frame by frame; `n` limits the output to the first n
        frames (a padded tail batch)."""
        boxes, scores, valid = self.detect_batch(frames)
        return [self.annotate_frame(frames[i], boxes, scores, valid, i)
                for i in range(len(frames) if n is None else n)]

    def detect_batch(self, frames: np.ndarray):
        """The device half of `process_batch`: (boxes (K, 4, 4), scores
        (K, 4), valid (K, 4)) on the host, scores demoted by the player
        detector's boxes where that is on."""
        boxes, scores, valid = self.sliced.detect_frames(frames)
        if self.player_detector is not None:
            det = self.player_detector.fetch_batch(frames)
            scores = demote_in_player_boxes(
                boxes, scores, det.boxes, det.valid,
                self.config.puck_player_demote,
                self.config.puck_demote_foot_band)
        return boxes, scores, valid

    def ingest(self, boxes: np.ndarray, scores: np.ndarray):
        """The tracker on one frame's detections; sets and returns
        (`last_center`, `last_detection`) and the selected index."""
        self.last_center, idx = self.tracker.ingest(boxes, scores)
        self.last_detection = None
        if idx is not None:
            b = boxes[idx]
            self.last_detection = ((b[0] + b[2]) / 2.0, (b[1] + b[3]) / 2.0)
        return self.last_center, self.last_detection, idx

    def annotate_frame(self, frame: np.ndarray, boxes, scores, valid,
                       i: int) -> np.ndarray:
        """The host half for frame `i`: tracker, box, trail."""
        v = valid[i]
        return self.annotate(frame, boxes[i][v], scores[i][v])

    def annotate(self, frame: np.ndarray, boxes: np.ndarray,
                 scores: np.ndarray) -> np.ndarray:
        """The tracker on one frame's detections, then a copy of the frame
        with the selected box and the trail drawn."""
        import cv2

        _, _, idx = self.ingest(boxes, scores)
        out = frame.copy()
        if idx is not None:
            bi = boxes[idx].astype(int)
            cv2.rectangle(out, (bi[0], bi[1]), (bi[2], bi[3]),
                          (0, 215, 255), 2)
        return self.tracker.draw_trail(out)
