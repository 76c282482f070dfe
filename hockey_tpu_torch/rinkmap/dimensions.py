"""NHL rink dimensions and the 56-keypoint rink-coordinate table: the
port's own copy of hockey_tpu/rinkmap/dimensions.py (numpy only).

- Rink frame: x along the long axis 0..200 ft, y across 0..85 ft, origin
  at the left-board/top-board corner.
- Keypoint ids: left zone 0-19, centre 20-35, right zone 36-55; within
  each zone the layout below is the JAX package's convention, which
  `hockey_tpu/data/keypoints.json` writes out and
  `load_keypoint_positions` reads ({id: [x_ft, y_ft]}) merged over the
  defaults.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class RinkDimensions:
    """NHL regulation sheet (feet)."""

    length: float = 200.0
    width: float = 85.0
    corner_radius: float = 28.0
    goal_line_from_end: float = 11.0
    blue_line_from_end: float = 75.0  # 64 ft from goal line
    faceoff_circle_radius: float = 15.0
    endzone_spot_from_goal_line: float = 20.0
    spot_offset_from_center_y: float = 22.0  # dot rows at 42.5 +/- 22
    neutral_spot_from_blue: float = 5.0
    crease_radius: float = 6.0

    @property
    def center_x(self) -> float:
        return self.length / 2.0

    @property
    def center_y(self) -> float:
        return self.width / 2.0


NHL = RinkDimensions()


def _end_zone_points(d: RinkDimensions, left: bool) -> list:
    """20 landmarks of one end zone, mirrored for the right side."""
    gl = d.goal_line_from_end if left else d.length - d.goal_line_from_end
    spot_x = (d.goal_line_from_end + d.endzone_spot_from_goal_line
              if left else d.length - d.goal_line_from_end - d.endzone_spot_from_goal_line)
    cy = d.center_y
    ytop = cy - d.spot_offset_from_center_y
    ybot = cy + d.spot_offset_from_center_y
    r = d.faceoff_circle_radius
    end_x = 0.0 if left else d.length
    corner = d.corner_radius
    sgn = 1.0 if left else -1.0
    pts = [
        (gl, 0.0),                    # 0 goal line @ top boards
        (gl, d.width),                # 1 goal line @ bottom boards
        (gl, cy - 3.0),               # 2 goal post (top)
        (gl, cy + 3.0),               # 3 goal post (bottom)
        (gl + sgn * d.crease_radius, cy),  # 4 crease front
        (spot_x, ytop),               # 5 faceoff spot top
        (spot_x, ybot),               # 6 faceoff spot bottom
        (spot_x, ytop - r),           # 7 circle top edge (top circle)
        (spot_x, ytop + r),           # 8 circle bottom edge (top circle)
        (spot_x - sgn * r, ytop),     # 9 circle goal-side edge (top)
        (spot_x + sgn * r, ytop),     # 10 circle blue-side edge (top)
        (spot_x, ybot - r),           # 11 circle top edge (bottom circle)
        (spot_x, ybot + r),           # 12 circle bottom edge (bottom circle)
        (spot_x - sgn * r, ybot),     # 13 circle goal-side edge (bottom)
        (spot_x + sgn * r, ybot),     # 14 circle blue-side edge (bottom)
        (end_x + sgn * corner, 0.0),  # 15 corner arc start (top boards)
        (end_x, corner),              # 16 corner arc end (side, top)
        (end_x + sgn * corner, d.width),  # 17 corner arc start (bottom)
        (end_x, d.width - corner),    # 18 corner arc end (side, bottom)
        (end_x, cy),                  # 19 end boards midpoint
    ]
    return pts


def _center_points(d: RinkDimensions) -> list:
    """16 neutral-zone landmarks (ids 20-35)."""
    cx, cy = d.center_x, d.center_y
    bl_l, bl_r = d.blue_line_from_end, d.length - d.blue_line_from_end
    ns_l = bl_l + d.neutral_spot_from_blue
    ns_r = bl_r - d.neutral_spot_from_blue
    ytop = cy - d.spot_offset_from_center_y
    ybot = cy + d.spot_offset_from_center_y
    r = d.faceoff_circle_radius
    return [
        (bl_l, 0.0),        # 20 left blue line @ top boards
        (bl_l, d.width),    # 21 left blue line @ bottom boards
        (bl_l, cy),         # 22 left blue line midpoint
        (bl_r, 0.0),        # 23 right blue line @ top boards
        (bl_r, d.width),    # 24 right blue line @ bottom boards
        (bl_r, cy),         # 25 right blue line midpoint
        (cx, 0.0),          # 26 center line @ top boards
        (cx, d.width),      # 27 center line @ bottom boards
        (cx, cy),           # 28 center ice dot
        (cx, cy - r),       # 29 center circle top
        (cx, cy + r),       # 30 center circle bottom
        (cx - r, cy),       # 31 center circle left
        (cx + r, cy),       # 32 center circle right
        (ns_l, ytop),       # 33 neutral spot left-top
        (ns_l, ybot),       # 34 neutral spot left-bottom
        (ns_r, ytop),       # 35 neutral spot right-top
    ]


def default_keypoint_positions(d: RinkDimensions = NHL) -> np.ndarray:
    """(56, 2) rink coordinates (feet) for keypoint ids 0..55."""
    pts = _end_zone_points(d, left=True) + _center_points(d) + _end_zone_points(d, left=False)
    assert len(pts) == 56
    return np.asarray(pts, np.float32)


def load_keypoint_positions(path: Optional[str] = None,
                            d: RinkDimensions = NHL) -> np.ndarray:
    """Load a keypoints.json override ({'<id>': [x_ft, y_ft], ...}) merged
    over the defaults."""
    pts = default_keypoint_positions(d)
    if path:
        with open(path) as f:
            table: Dict[str, list] = json.load(f)
        for k, v in table.items():
            pts[int(k)] = v
    return pts


# Stable keypoint ids for homography (reference README.md:77).
STABLE_KEYPOINT_IDS = [4, 5, 11, 12, 17, 18, 14, 20, 22, 24, 25, 26, 27,
                       37, 45, 38, 44, 50, 51, 55, 54, 41, 40]
