"""SmoothAnnotator: display-only box smoothing wrapper, port of
hockey_tpu/annotate/smooth.py (reference smooth_annotator.py:8-93):

- smooths boxes per tracker id for *annotation only* (detections unmodified);
- bypasses smoothing when there are no tracker ids;
- cleans up the state of trackers absent from the current frame;
- picks the stabilizer by use_adaptive (V2 adaptive vs V1 Kalman).

Numpy only; the wrapped annotator imports OpenCV when it draws.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .draw import BoxAnnotator
from .stabilizers import make_stabilizer


class SmoothAnnotator:
    def __init__(
        self,
        annotator: BoxAnnotator,
        smoothing_factor: float = 0.3,
        use_adaptive: bool = True,
    ):
        self.annotator = annotator
        self.stabilizer = make_stabilizer(smoothing_factor, use_adaptive)

    def smooth_boxes(
        self,
        boxes: np.ndarray,
        tracker_ids: Optional[np.ndarray],
        confidences: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Returns smoothed display boxes; input boxes untouched."""
        if tracker_ids is None or len(boxes) == 0:
            return np.asarray(boxes)
        smoothed = self.stabilizer.update_batch(tracker_ids, boxes, confidences)
        self.stabilizer.cleanup(tracker_ids)
        return smoothed

    def annotate(
        self,
        scene: np.ndarray,
        boxes: np.ndarray,
        tracker_ids: Optional[np.ndarray] = None,
        confidences: Optional[np.ndarray] = None,
        color_lookup: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        display = self.smooth_boxes(boxes, tracker_ids, confidences)
        return self.annotator.annotate(scene, display, color_lookup)
