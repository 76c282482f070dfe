"""ViewTransformer: points and boxes between image pixels and rink feet
through a homography. The port's own copy of
hockey_tpu/homography/view.py (numpy only).
"""

from __future__ import annotations

import numpy as np

from .ransac import project


class ViewTransformer:
    def __init__(self, homography: np.ndarray):
        """`homography` maps image px -> rink feet (3, 3)."""
        self.h = np.asarray(homography, np.float64)
        self.h_inv = np.linalg.inv(self.h)

    @classmethod
    def from_points(cls, image_points: np.ndarray,
                    rink_points: np.ndarray) -> "ViewTransformer":
        from .ransac import dlt_homography

        h = dlt_homography(np.asarray(image_points, np.float64),
                           np.asarray(rink_points, np.float64))
        if h is None:
            raise ValueError("degenerate correspondence set")
        return cls(h)

    def image_to_rink(self, points: np.ndarray) -> np.ndarray:
        """(N, 2) image px -> (N, 2) rink feet."""
        return project(self.h, np.asarray(points, np.float64))

    def rink_to_image(self, points: np.ndarray) -> np.ndarray:
        """(N, 2) rink feet -> (N, 2) image px."""
        return project(self.h_inv, np.asarray(points, np.float64))

    def boxes_to_rink(self, boxes: np.ndarray) -> np.ndarray:
        """Player boxes (N, 4) xyxy -> rink positions via the bottom-center
        anchor (players stand on the ice at their box's bottom edge)."""
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        anchors = np.stack(
            [(boxes[:, 0] + boxes[:, 2]) / 2.0, boxes[:, 3]], axis=1)
        return self.image_to_rink(anchors)
