"""The 2D overhead rink map (--show-2d-map): port of
hockey_tpu/rinkmap/renderer.py (`RinkRenderer`, `bottom_center_anchors`).

An NHL-proportioned sheet, the players' bottom-centre anchors (and the
puck) projected through the image-to-rink homography, composited into a
corner of the frame. Drawing imports OpenCV inside the functions and the
sheet is drawn at the first render, so building a renderer needs no
OpenCV.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.config import Config, hex_to_bgr
from ..homography.ransac import project
from .dimensions import NHL, RinkDimensions

_ICE = (245, 242, 238)
_LINE_RED = (60, 60, 200)
_LINE_BLUE = (200, 120, 30)
_BOARD = (90, 90, 90)


class RinkRenderer:
    def __init__(self, d: RinkDimensions = NHL, px_per_ft: float = 3.0,
                 config: Optional[Config] = None):
        self.d = d
        self.scale = px_per_ft
        self.w = int(d.length * px_per_ft)
        self.h = int(d.width * px_per_ft)
        cfg = config or Config()
        self.team_colors = [hex_to_bgr(c) for c in cfg.team_colors]
        self._base: Optional[np.ndarray] = None  # drawn at the first render

    def _pt(self, x_ft: float, y_ft: float) -> Tuple[int, int]:
        return (int(x_ft * self.scale), int(y_ft * self.scale))

    def _draw_base(self) -> np.ndarray:
        import cv2

        d = self.d
        img = np.full((self.h, self.w, 3), _ICE, np.uint8)
        r = int(d.corner_radius * self.scale)
        # boards (rounded rectangle)
        cv2.rectangle(img, (0, 0), (self.w - 1, self.h - 1), _BOARD, 3)
        for cx, cy, a0 in [(r, r, 180), (self.w - r, r, 270),
                           (self.w - r, self.h - r, 0), (r, self.h - r, 90)]:
            cv2.ellipse(img, (cx, cy), (r, r), 0, a0, a0 + 90, _BOARD, 3)
        # center line + circle
        cv2.line(img, self._pt(d.center_x, 0), self._pt(d.center_x, d.width), _LINE_RED, 3)
        cv2.circle(img, self._pt(d.center_x, d.center_y),
                   int(d.faceoff_circle_radius * self.scale), _LINE_BLUE, 2)
        cv2.circle(img, self._pt(d.center_x, d.center_y), 4, _LINE_BLUE, -1)
        # blue lines
        for x in (d.blue_line_from_end, d.length - d.blue_line_from_end):
            cv2.line(img, self._pt(x, 0), self._pt(x, d.width), _LINE_BLUE, 3)
        # goal lines, creases, end-zone circles
        cy = d.center_y
        for left in (True, False):
            sgn = 1 if left else -1
            gl = d.goal_line_from_end if left else d.length - d.goal_line_from_end
            cv2.line(img, self._pt(gl, 0), self._pt(gl, d.width), _LINE_RED, 2)
            cv2.ellipse(img, self._pt(gl, cy),
                        (int(d.crease_radius * self.scale),) * 2,
                        0, -90 if left else 90, 90 if left else 270, _LINE_BLUE, 2)
            spot_x = gl + sgn * d.endzone_spot_from_goal_line
            for y in (cy - d.spot_offset_from_center_y, cy + d.spot_offset_from_center_y):
                cv2.circle(img, self._pt(spot_x, y),
                           int(d.faceoff_circle_radius * self.scale), _LINE_RED, 2)
                cv2.circle(img, self._pt(spot_x, y), 3, _LINE_RED, -1)
        return img

    # ------------------------------------------------------------------
    def render(
        self,
        homography: Optional[np.ndarray] = None,
        player_positions: Optional[np.ndarray] = None,
        team_ids: Optional[Sequence[int]] = None,
        puck_position: Optional[Tuple[float, float]] = None,
    ) -> np.ndarray:
        """Overhead map with projected entities. `player_positions` are
        image-space (N, 2) bottom-center anchor points; `homography` maps
        image -> rink feet. Pre-projected rink coordinates may be passed
        with homography=None and positions in feet."""
        import cv2

        if self._base is None:
            self._base = self._draw_base()
        img = self._base.copy()
        if player_positions is not None and len(player_positions):
            pts = np.asarray(player_positions, np.float64)
            rink_pts = project(homography, pts) if homography is not None else pts
            for i, (x, y) in enumerate(rink_pts):
                if not (0 <= x <= self.d.length and 0 <= y <= self.d.width):
                    continue
                team = int(team_ids[i]) if team_ids is not None and i < len(team_ids) else 0
                color = self.team_colors[team % len(self.team_colors)]
                cv2.circle(img, self._pt(x, y), 6, color, -1)
                cv2.circle(img, self._pt(x, y), 6, (30, 30, 30), 1)
        if puck_position is not None:
            p = (project(homography, np.asarray([puck_position], np.float64))[0]
                 if homography is not None else puck_position)
            if 0 <= p[0] <= self.d.length and 0 <= p[1] <= self.d.width:
                cv2.circle(img, self._pt(p[0], p[1]), 4, (0, 0, 0), -1)
        return img

    def overlay(self, frame: np.ndarray, rink_map: np.ndarray,
                corner: str = "bottom-right", margin: int = 12,
                width_frac: float = 0.3, alpha: float = 0.9) -> np.ndarray:
        """Composite the map into a corner of the frame."""
        import cv2

        fh, fw = frame.shape[:2]
        mw = int(fw * width_frac)
        mh = int(mw * rink_map.shape[0] / rink_map.shape[1])
        small = cv2.resize(rink_map, (mw, mh))
        x0 = margin if "left" in corner else fw - mw - margin
        y0 = margin if "top" in corner else fh - mh - margin
        roi = frame[y0:y0 + mh, x0:x0 + mw]
        frame[y0:y0 + mh, x0:x0 + mw] = cv2.addWeighted(small, alpha, roi, 1 - alpha, 0)
        return frame


def bottom_center_anchors(boxes: np.ndarray) -> np.ndarray:
    """Players stand on the ice at their box's bottom-center."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    return np.stack([(boxes[:, 0] + boxes[:, 2]) / 2.0, boxes[:, 3]], axis=1)
