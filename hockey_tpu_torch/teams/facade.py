"""TeamClassifier, the cascade of strategies: port of
hockey_tpu/teams/facade.py (reference team.py:37-331).

- Priority: segmentation > interactive > robust > hybrid > simple, each
  enabled by a use_* flag (all on by default, so segmentation is active).
- A failed fit or prediction demotes to the next enabled strategy and
  retries it: a classifier's exception never ends the video run. After a
  failed prediction the strategy demoted to is fitted on the arguments of
  the last `fit` (hockey_tpu facade.py:130-145). The interactive strategy
  needs the click UI: headless, or without a frame, its fit fails and
  demotes.
- The team-name registry, "Team 0" / "Team 1" by default.
- Labels: 0 = away / white, 1 = home / coloured.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.device import resolve_device
from .base import host_crops
from .hybrid import HybridTeamClassifier
from .interactive import InteractiveTeamClassifier
from .robust import RobustTeamClassifier
from .segmentation import SegmentationTeamClassifier
from .simple import SimpleTeamClassifier

_ORDER = ["segmentation", "interactive", "robust", "hybrid", "simple"]


class TeamClassifier:
    def __init__(
        self,
        device="cuda",
        batch_size: int = 32,
        use_hybrid: bool = True,
        use_robust: bool = True,
        use_interactive: bool = True,
        use_segmentation: bool = True,
        segmentation_method: str = "color_prior",
    ):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.segmentation_method = segmentation_method
        self.team_names: Dict[int, str] = {0: "Team 0", 1: "Team 1"}
        enabled = {
            "segmentation": use_segmentation,
            "interactive": use_interactive,
            "robust": use_robust,
            "hybrid": use_hybrid,
            "simple": True,
        }
        self._chain: List[str] = [s for s in _ORDER if enabled[s]]
        self._impl = None
        self._impl_name: Optional[str] = None
        self._activate(self._chain[0])
        self._fit_args = None

    @property
    def active_strategy(self) -> str:
        return self._impl_name

    def _activate(self, name: str) -> None:
        if name == "segmentation":
            self._impl = SegmentationTeamClassifier(
                self.device, visualize_segmentation=True,
                method=self.segmentation_method)
        elif name == "interactive":
            self._impl = InteractiveTeamClassifier(self.device)
        elif name == "robust":
            self._impl = RobustTeamClassifier(self.device)
        elif name == "hybrid":
            self._impl = HybridTeamClassifier(self.device)
        else:
            self._impl = SimpleTeamClassifier(self.device)
        self._impl_name = name

    def _demote(self) -> bool:
        idx = self._chain.index(self._impl_name)
        if idx + 1 >= len(self._chain):
            return False
        self._activate(self._chain[idx + 1])
        return True

    def fit(self, crops: List[np.ndarray], positions=None, frame=None,
            detections=None) -> None:
        """Fit the active strategy; on failure demote and fit the next.
        `frame` and `detections` ((boxes, tracker_ids)) are for the
        interactive strategy."""
        self._fit_args = (crops, positions, frame, detections)
        while True:
            try:
                self._fit_active(crops, positions, frame, detections)
                return
            except Exception as e:
                print(f"{self._impl_name} classifier failed: {e}")
                if not self._demote():
                    return
                print(f"Falling back to {self._impl_name} classifier")

    def _fit_active(self, crops, positions, frame, detections) -> None:
        if self._impl_name == "interactive":
            if frame is None or detections is None:
                raise ValueError("Interactive classifier needs frame and detections")
            if not self._impl.initialize_from_user_selection(frame, detections):
                raise RuntimeError("Interactive selection cancelled")
        elif self._impl_name == "simple":
            self._impl.fit(crops)
        else:
            self._impl.fit(crops, positions=positions)

    def predict(self, crops, tracker_ids: Optional[np.ndarray] = None,
                positions=None) -> np.ndarray:
        if not len(crops):
            return np.array([])
        while True:
            try:
                if self._impl_name == "robust":
                    return self._impl.get_team_labels(
                        self._impl.predict(crops, tracker_ids, positions))
                if self._impl_name in ("interactive", "hybrid"):
                    return self._impl.predict(crops, tracker_ids)
                return self._impl.predict(crops, tracker_ids, positions)
            except Exception as e:
                print(f"{self._impl_name} prediction failed: {e}")
                if not self._demote():
                    raise
                print(f"Falling back to {self._impl_name} classifier")
                if self._fit_args is not None and self._impl_name != "simple":
                    c, p, f, d = self._fit_args
                    try:  # a refit that fails leaves the strategy unfitted
                        if self._impl_name != "interactive" or (
                                f is not None and d is not None):
                            self._fit_active(c, p, f, d)
                    except Exception:
                        pass

    def supports_fused_features(self) -> bool:
        """True when the active strategy classifies the fused detect step's
        4-dim features directly (segmentation)."""
        return hasattr(self._impl, "predict_features")

    def predict_features(self, feats: np.ndarray,
                         tracker_ids: Optional[np.ndarray] = None) -> np.ndarray:
        return self._impl.predict_features(feats, tracker_ids)

    def predict_from_frame(self, frame: np.ndarray, boxes: np.ndarray,
                           tracker_ids: Optional[np.ndarray] = None,
                           positions=None) -> np.ndarray:
        """Crops sampled on the device where the active strategy can;
        otherwise host crops and `predict`."""
        if hasattr(self._impl, "predict_from_frame"):
            try:
                return self._impl.predict_from_frame(frame, boxes, tracker_ids)
            except Exception as e:
                print(f"{self._impl_name} frame-predict failed: {e}")
        return self.predict(host_crops(frame, boxes), tracker_ids, positions)

    def get_segmentation_masks(self, tracker_ids) -> Optional[Dict[int, np.ndarray]]:
        if self._impl_name == "segmentation":
            return self._impl.get_segmentation_masks(tracker_ids)
        return None

    def set_team_names(self, team_names: Dict[int, str]) -> None:
        self.team_names.update(team_names)

    def get_team_name(self, team_id: int) -> str:
        return self.team_names.get(int(team_id), f"Team {team_id}")
