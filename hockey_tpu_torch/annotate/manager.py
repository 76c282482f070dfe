"""AnnotationManager, one object owning the annotators: port of
hockey_tpu/annotate/manager.py (reference hockey/main.py:90-141).

It builds the configured box annotator wrapped in the SmoothAnnotator and
the label annotator from a Config; `annotate_frame` draws boxes, then
labels. The reference's rink-keypoint branch there is `pass`: keypoints
are drawn by `RinkKeypointDetector.visualize_keypoints`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.config import Config
from .draw import make_annotators
from .smooth import SmoothAnnotator


class AnnotationManager:
    def __init__(self, config: Optional[Config] = None):
        self.config = config or Config()
        box_annotator, self.label_annotator = make_annotators(self.config)
        self.box_annotator = SmoothAnnotator(
            box_annotator, smoothing_factor=self.config.smoothing_factor,
            use_adaptive=self.config.use_adaptive_smoothing)

    def annotate_frame(self, frame: np.ndarray, boxes: np.ndarray,
                       labels: Sequence[str], color_lookup: np.ndarray,
                       tracker_ids: Optional[np.ndarray] = None,
                       confidences: Optional[np.ndarray] = None,
                       rink_keypoints: Optional[List] = None) -> np.ndarray:
        out = self.box_annotator.annotate(frame.copy(), boxes, tracker_ids,
                                          confidences, color_lookup)
        return self.label_annotator.annotate(out, boxes, labels, color_lookup)
