"""Team selector: port of hockey_tpu/ui/team_selector.py (reference
team_selector.py:8-243).

`select_teams(frame, boxes, tracker_ids)` opens an OpenCV window where the
user clicks the HOME players, then the AWAY players (a click toggles,
SPACE goes on, ESC cancels), then types each team's name (ENTER confirms,
BACKSPACE edits, at most 10 characters). It returns a TeamSelection; the
pipeline reads only its team names. `pick_team_examples(frame, boxes)`
runs the same UI to pick the interactive classifier's example players.

Headless: with `headless_names`, with HOCKEY_TPU_HEADLESS set to anything
but "" or "0", or with no DISPLAY, it returns at once with the given
names or ("HOME", "AWAY"). OpenCV is imported only by the click UI.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TeamSelection:
    team_names: Dict[int, str]
    selected_players: Dict[int, List[int]]


def _headless() -> bool:
    return (os.environ.get("HOCKEY_TPU_HEADLESS", "") not in ("", "0")
            or not os.environ.get("DISPLAY"))


class InteractiveTeamSelector:
    def __init__(self, headless_names: Optional[Tuple[str, str]] = None):
        self.headless_names = headless_names

    def select_teams(self, frame: np.ndarray, boxes: np.ndarray,
                     tracker_ids: Optional[np.ndarray] = None) -> Optional[TeamSelection]:
        boxes = np.asarray(boxes).reshape(-1, 4)
        if tracker_ids is None:
            tracker_ids = np.arange(1, len(boxes) + 1)
        if self.headless_names is not None or _headless():
            names = self.headless_names or ("HOME", "AWAY")
            return TeamSelection(team_names={0: names[0], 1: names[1]},
                                 selected_players={0: [], 1: []})
        return self._select_ui(frame, boxes, tracker_ids)

    def _select_ui(self, frame, boxes, tracker_ids) -> Optional[TeamSelection]:
        import cv2

        selected: Dict[int, List[int]] = {0: [], 1: []}
        phase = {"team": 0}
        window = "Team Selection"

        def on_mouse(event, x, y, flags, param):
            if event != cv2.EVENT_LBUTTONDOWN:
                return
            hit = [i for i, b in enumerate(boxes)
                   if b[0] <= x <= b[2] and b[1] <= y <= b[3]]
            if not hit:
                return
            tid = int(tracker_ids[hit[0]])
            lst = selected[phase["team"]]
            if tid in lst:
                lst.remove(tid)
            elif tid not in selected[1 - phase["team"]]:
                lst.append(tid)

        cv2.namedWindow(window)
        cv2.setMouseCallback(window, on_mouse)
        try:
            while True:
                vis = frame.copy()
                label = "HOME (colored)" if phase["team"] == 0 else "AWAY (white)"
                cv2.putText(vis, f"Click {label} players - SPACE next, ESC cancel",
                            (20, 40), cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 255, 255), 2)
                for i, b in enumerate(boxes):
                    tid = int(tracker_ids[i])
                    color = ((0, 0, 255) if tid in selected[0] else
                             (255, 255, 255) if tid in selected[1] else
                             (128, 128, 128))
                    cv2.rectangle(vis, (int(b[0]), int(b[1])),
                                  (int(b[2]), int(b[3])), color, 2)
                cv2.imshow(window, vis)
                key = cv2.waitKey(30) & 0xFF
                if key == 27:  # ESC
                    return None
                if key == 32:  # SPACE
                    if phase["team"] == 1:
                        break
                    phase["team"] = 1
            name0 = self._get_team_name("Enter HOME team name")
            if name0 is None:
                return None
            name1 = self._get_team_name("Enter AWAY team name")
            if name1 is None:
                return None
            return TeamSelection(team_names={0: name1 or "AWAY", 1: name0 or "HOME"},
                                 selected_players=selected)
        finally:
            cv2.destroyAllWindows()

    @staticmethod
    def _get_team_name(prompt: str, max_len: int = 10) -> Optional[str]:
        import cv2

        name = ""
        window = "Team Name"
        while True:
            canvas = np.zeros((120, 480, 3), np.uint8)
            cv2.putText(canvas, prompt, (10, 40), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                        (255, 255, 255), 2)
            cv2.putText(canvas, name + "_", (10, 90), cv2.FONT_HERSHEY_SIMPLEX,
                        0.9, (0, 255, 0), 2)
            cv2.imshow(window, canvas)
            key = cv2.waitKey(30) & 0xFF
            if key == 27:
                cv2.destroyWindow(window)
                return None
            if key in (13, 10):
                cv2.destroyWindow(window)
                return name
            if key == 8:
                name = name[:-1]
            elif 32 <= key < 127 and len(name) < max_len:
                name += chr(key)


def pick_team_examples(frame: np.ndarray, boxes: np.ndarray
                       ) -> Optional[Tuple[List[np.ndarray], List[np.ndarray]]]:
    """The interactive classifier's example picking in the click UI
    (reference team_interactive.py:54-132; hockey_tpu team_selector.py:146):
    (team 0 boxes, team 1 boxes) with at least 2 each, or None when
    headless or cancelled."""
    if _headless():
        return None
    sel = InteractiveTeamSelector().select_teams(frame, boxes)
    if sel is None:
        return None
    ids = {int(i): b for i, b in enumerate(boxes)}
    t0 = [ids[i - 1] for i in sel.selected_players.get(0, []) if i - 1 in ids]
    t1 = [ids[i - 1] for i in sel.selected_players.get(1, []) if i - 1 in ids]
    if len(t0) < 2 or len(t1) < 2:
        return None
    return t0, t1
