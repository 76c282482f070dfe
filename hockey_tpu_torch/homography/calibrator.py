"""The homography calibrator's engine: the port's own copy of
hockey_tpu/homography/calibrator.py (`CalibrationProfile`,
`CameraMovementDetector`, `CalibratorState`), numpy only.

- manual keypoint edits (select, drag, remove) override detections;
- keys: H help, L lock/unlock, R recalculate, G save a segment, C
  confidence display (S, saving, is the owner's);
- camera motion (mean absolute difference of a 36x64 gray probe)
  triggers a recalculation or the reuse of a saved segment whose probe
  matches;
- tiered RANSAC fits feed the `HomographyStabilizer`;
- profiles (homography and manual points) save to and load from JSON.

The JAX package's motion probe calls `cv2.cvtColor` and `cv2.resize`;
here the same uint8 arithmetic runs in numpy (`ops/gray.py`), so the
probe and its `moved` flags are equal and the GPU machine needs no
OpenCV. The state machine is headless; a window loop would only feed it
events.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.gray import gray_resize
from ..rinkmap.dimensions import default_keypoint_positions
from .ransac import fit_homography_tiered
from .stabilizer import HomographyStabilizer


@dataclasses.dataclass
class CalibrationProfile:
    homography: List[List[float]]
    manual_points: Dict[str, Tuple[float, float]]
    source: str = ""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "CalibrationProfile":
        d = json.loads(s)
        return cls(**d)


class CameraMovementDetector:
    """Downsampled gray frame differencing; large mean abs diff = moving."""

    def __init__(self, threshold: float = 12.0, probe: Tuple[int, int] = (36, 64)):
        self.threshold = threshold
        self.probe = probe
        self._last: Optional[np.ndarray] = None

    def update(self, frame: np.ndarray) -> bool:
        """Feed a (H, W, 3) uint8 BGR frame; True when it moved against the
        last one. The gray probe is OpenCV's cvtColor + INTER_LINEAR
        resize, bit for bit, without OpenCV (`ops/gray.py`)."""
        g = gray_resize(frame, self.probe).astype(np.float32)
        moved = False
        if self._last is not None:
            moved = float(np.abs(g - self._last).mean()) > self.threshold
        self._last = g
        return moved


class CalibratorState:
    """Headless calibration engine; the UI is just an event source."""

    def __init__(self, frame_hw: Tuple[int, int] = (1080, 1920),
                 keypoint_table: Optional[np.ndarray] = None,
                 coarse_max_error_ft: float = 12.0):
        self.frame_hw = frame_hw
        self.table = (keypoint_table if keypoint_table is not None
                      else default_keypoint_positions())
        # coarse-tier fallback gate in rink ft; 0 disables (COMPAT #25)
        self.coarse_max_error_ft = coarse_max_error_ft
        self.manual_points: Dict[int, Tuple[float, float]] = {}
        self.detected_keypoints: List = []
        self.stabilizer = HomographyStabilizer(frame_hw=frame_hw)
        self.movement = CameraMovementDetector()
        self.segments: List[Tuple[np.ndarray, np.ndarray]] = []  # (pose probe, H)
        self.show_help = False
        self.show_confidence = False
        self.selected: Optional[int] = None
        self.status = ""
        self.last_quality = None  # HomographyQuality of the last RANSAC fit
        self.last_tier: Optional[str] = None  # 'fine' | 'coarse' | None

    # -- keypoint editing ------------------------------------------------
    def select_near(self, x: float, y: float, radius: float = 20.0) -> Optional[int]:
        best, best_d = None, radius
        for kp in self.detected_keypoints:
            d = float(np.hypot(kp.position[0] - x, kp.position[1] - y))
            if d < best_d:
                best, best_d = kp.id, d
        for kid, pos in self.manual_points.items():
            d = float(np.hypot(pos[0] - x, pos[1] - y))
            if d < best_d:
                best, best_d = kid, d
        self.selected = best
        return best

    def drag_to(self, x: float, y: float) -> None:
        if self.selected is not None:
            self.manual_points[self.selected] = (float(x), float(y))

    def remove_near(self, x: float, y: float, radius: float = 20.0) -> None:
        for kid, pos in list(self.manual_points.items()):
            if np.hypot(pos[0] - x, pos[1] - y) < radius:
                del self.manual_points[kid]

    # -- calibration -----------------------------------------------------
    def effective_correspondences(self, min_confidence: float = 0.5):
        """Detected keypoints with manual overrides applied on top."""
        src, dst = [], []
        seen = set()
        for kid, pos in self.manual_points.items():
            src.append(pos)
            dst.append(self.table[kid])
            seen.add(kid)
        for kp in self.detected_keypoints:
            if kp.id in seen or kp.confidence < min_confidence:
                continue
            src.append(kp.position)
            dst.append(self.table[kp.id])
        return np.asarray(src, np.float64), np.asarray(dst, np.float64)

    def _fit_and_update(self, set_status: bool) -> Optional[np.ndarray]:
        """Tiered RANSAC fit over the effective correspondences, fed into
        the stabilizer. Fine fits (3-ft gate) are authoritative; coarse
        fits (<= coarse_max_error_ft) keep the 2D map alive when keypoint
        quality is degraded (COMPAT #25)."""
        src, dst = self.effective_correspondences()
        if len(src) < 4:
            if set_status:
                self.status = f"Need >= 4 points ({len(src)} available)"
            return self.stabilizer.current
        h, quality, tier = fit_homography_tiered(
            src, dst, coarse_threshold=self.coarse_max_error_ft)
        self.last_quality = quality  # exported via --json-metrics gauges
        self.last_tier = tier
        if h is None:
            if set_status:
                self.status = "Calibration rejected (low quality)"
            return self.stabilizer.current
        if set_status:
            self.status = (f"OK ({tier}): {quality.inlier_ratio:.0%} "
                           f"inliers, err "
                           f"{quality.mean_reprojection_error:.2f} ft")
        return self.stabilizer.update(h, tier=tier)

    def recalculate(self) -> Optional[np.ndarray]:
        return self._fit_and_update(set_status=True)

    def process_frame(self, frame: np.ndarray, keypoints: List) -> Optional[np.ndarray]:
        """Per-frame: refresh detections, auto-recalculate on camera motion
        or when uninitialized, try segment reuse."""
        self.detected_keypoints = keypoints
        moved = self.movement.update(frame)
        if moved:
            reused = self._reuse_segment()
            if reused is None:
                self.recalculate()
        elif self.stabilizer.current is None:
            self.recalculate()
        else:
            # steady state: same tiered fit, quieter status churn; manual
            # overrides apply here too (they are user ground truth)
            self._fit_and_update(set_status=False)
        return self.stabilizer.current

    # -- segments ---------------------------------------------------------
    def save_segment(self) -> bool:
        """'G' hotkey: remember the current pose probe + homography."""
        if self.stabilizer.current is None or self.movement._last is None:
            return False
        self.segments.append((self.movement._last.copy(),
                              self.stabilizer.current.copy()))
        self.status = f"Segment saved ({len(self.segments)} total)"
        return True

    def _reuse_segment(self) -> Optional[np.ndarray]:
        if self.movement._last is None:
            return None
        for probe, h in self.segments:
            if float(np.abs(probe - self.movement._last).mean()) < self.movement.threshold:
                self.stabilizer.current = h.copy()
                self.status = "Reused saved calibration segment"
                return h
        return None

    # -- hotkeys ------------------------------------------------------------
    def drive_key(self, key: str) -> None:
        key = key.lower()
        if key == "h":
            self.show_help = not self.show_help
        elif key == "l":
            self.stabilizer.lock(not self.stabilizer.locked)
            self.status = "Homography locked" if self.stabilizer.locked else "Unlocked"
        elif key == "r":
            self.recalculate()
        elif key == "g":
            self.save_segment()
        elif key == "c":
            self.show_confidence = not self.show_confidence
        # 's' handled by the owner (needs a path)

    # -- persistence ---------------------------------------------------------
    def save_profile(self, path: str, source: str = "") -> None:
        if self.stabilizer.current is None:
            raise ValueError("No calibration to save")
        prof = CalibrationProfile(
            homography=self.stabilizer.current.tolist(),
            manual_points={str(k): v for k, v in self.manual_points.items()},
            source=source,
        )
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(prof.to_json())
        self.status = f"Saved {path}"

    def load_profile(self, path: str) -> None:
        with open(path) as f:
            prof = CalibrationProfile.from_json(f.read())
        self.stabilizer.current = np.asarray(prof.homography, np.float64)
        self.manual_points = {int(k): tuple(v) for k, v in prof.manual_points.items()}
        self.status = f"Loaded {path}"

    @staticmethod
    def profile_path_for(video_path: str) -> str:
        """Per-video calibration storage (README.md:116)."""
        base, _ = os.path.splitext(video_path)
        return base + ".calibration.json"
