"""Rink keypoints of the 56-point YOLO pose model: port of
hockey_tpu/homography/keypoints.py (`RinkKeypoint`, `KEYPOINT_GROUPS`,
`zone_of`, `keypoints_from_array`, `RinkKeypointDetector`).

Zones: left 0-19, centre 20-35, right 36-55; a keypoint is named
"{zone}_kpt_{i}" and kept when its confidence reaches the threshold.
Drawing imports OpenCV inside `visualize_keypoints`, so the module loads
without it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..core.config import Config


@dataclasses.dataclass
class RinkKeypoint:
    id: int
    name: str
    position: Tuple[float, float]
    confidence: float


KEYPOINT_GROUPS = {
    "left_zone": list(range(0, 20)),
    "center_zone": list(range(20, 36)),
    "right_zone": list(range(36, 56)),
}

_ZONE_COLORS = {
    "left": (0, 255, 0),
    "center": (255, 191, 0),
    "right": (71, 99, 255),
    "unknown": (255, 255, 255),
}


def zone_of(idx: int) -> str:
    for name, ids in KEYPOINT_GROUPS.items():
        if idx in ids:
            return name
    return "unknown"


def keypoints_from_array(kpts: np.ndarray,
                         conf_threshold: float = 0.5) -> List[RinkKeypoint]:
    """(56, 3) raw keypoints (e.g. a dual-megastep row) -> filtered
    RinkKeypoint list (same semantics as detect_keypoints)."""
    out = []
    for i, (x, y, c) in enumerate(np.asarray(kpts)):
        if c < conf_threshold:
            continue
        z = zone_of(i)
        out.append(RinkKeypoint(i, f"{z}_kpt_{i}", (float(x), float(y)), float(c)))
    return out


class RinkKeypointDetector:
    """The pose model alone: a pose `Detector` (models/detector.py) at
    `rink_imgsz` with the minimal-rectangle letterbox, its boxes through
    the NMS kernel, one device step per frame batch. The pipeline uses it
    where a player detector is injected (else the dual step,
    models/dual.py, computes the keypoints)."""

    def __init__(self, model_name: str = "hockey-detection",
                 config: Optional[Config] = None,
                 frame_hw: Tuple[int, int] = (1080, 1920),
                 checkpoint: Optional[str] = None, device="cuda",
                 dtype=None):
        from ..models.detector import Detector

        self.config = config or Config()
        self.detector = Detector(
            model_name, self.config, frame_hw=frame_hw, checkpoint=checkpoint,
            imgsz=self.config.rink_imgsz, device=device, dtype=dtype)

    def detect_keypoints(self, frame: np.ndarray,
                         conf_threshold: float = 0.5) -> List[RinkKeypoint]:
        """Single frame -> confidence-filtered keypoints of the best rink
        instance (reference takes results[0].keypoints.data[0])."""
        return keypoints_from_array(self.detect_keypoints_batch(frame[None])[0],
                                    conf_threshold)

    def detect_keypoints_batch(self, frames: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) -> (B, 56, 3) raw keypoints on the host: x, y in
        frame px and the confidence."""
        _, kpts = self.detector.detect_batch(frames)
        return kpts.cpu().numpy()

    # ------------------------------------------------------------------
    @staticmethod
    def visualize_keypoints(frame: np.ndarray, keypoints: List[RinkKeypoint],
                            radius: int = 8, show_labels: bool = True) -> np.ndarray:
        """A copy of `frame` with each keypoint drawn: shaded zone-coloured
        disc, white ring, 'id:conf' label (OpenCV, imported here)."""
        import cv2

        annotated = frame.copy()
        for kp in keypoints:
            x, y = int(kp.position[0]), int(kp.position[1])
            color = _ZONE_COLORS.get(kp.name.split("_")[0], _ZONE_COLORS["unknown"])
            for r in range(radius + 4, 0, -1):
                alpha = 1.0 - r / (radius + 4)
                cv2.circle(annotated, (x, y), r, tuple(int(c * alpha) for c in color), -1)
            cv2.circle(annotated, (x, y), radius, color, -1)
            cv2.circle(annotated, (x, y), radius, (255, 255, 255), 2)
            if show_labels:
                label = f"{kp.id}:{kp.confidence:.2f}"
                (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
                cv2.rectangle(annotated, (x - tw // 2 - 2, y - radius - th - 4),
                              (x + tw // 2 + 2, y - radius - 2), (0, 0, 0), -1)
                cv2.putText(annotated, label, (x - tw // 2, y - radius - 4),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
        return annotated

    def get_rink_homography(self, keypoints: List[RinkKeypoint]) -> Optional[np.ndarray]:
        """Keypoints -> image-to-rink homography, or None
        (`ransac.homography_from_keypoints`)."""
        from .ransac import homography_from_keypoints

        return homography_from_keypoints(keypoints)
