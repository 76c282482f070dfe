"""ModelManager, named-model loading with an existence check: port of
hockey_tpu/models/manager.py (reference hockey/main.py:62-87).

A model resolves to `<data_dir>/<name>.msgpack`. A missing file raises
FileNotFoundError, as the reference does, unless `allow_random_init`:
then the model loads the JAX package's shipped checkpoint of that name
(the port builds no model from random weights). The port's Detector,
RinkKeypointDetector and PuckPipeline are built on the manager's device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

from ..core.config import Config
from ..core.device import resolve_device


class ModelManager:
    def __init__(self, data_dir: Optional[str] = None,
                 config: Optional[Config] = None,
                 allow_random_init: bool = False, device="cuda"):
        self.config = config or Config()
        self.data_dir = Path(data_dir) if data_dir else Path("data")
        self.allow_random_init = allow_random_init
        self.device = resolve_device(device)
        self.player_model = None
        self.rink_detector = None
        self.puck_model = None

    def _checkpoint_for(self, name: str) -> Optional[str]:
        path = self.data_dir / f"{name}.msgpack"
        if path.exists():
            return str(path)
        if self.allow_random_init:
            return None
        raise FileNotFoundError(f"Model checkpoint not found: {path}")

    def load_player_model(self, frame_hw: Tuple[int, int] = (1080, 1920)):
        from .detector import Detector

        name = self.config.player_model_name
        self.player_model = Detector(
            name, self.config, frame_hw=frame_hw,
            checkpoint=self._checkpoint_for(name), device=self.device)
        return self.player_model

    def load_rink_detector(self, frame_hw: Tuple[int, int] = (1080, 1920)):
        from ..homography.keypoints import RinkKeypointDetector

        name = self.config.hockey_model_name
        self.rink_detector = RinkKeypointDetector(
            name, self.config, frame_hw=frame_hw,
            checkpoint=self._checkpoint_for(name), device=self.device)
        return self.rink_detector

    def load_puck_pipeline(self, frame_hw: Tuple[int, int] = (1080, 1920)):
        from ..slicing.sahi import PuckPipeline

        self.puck_model = PuckPipeline(
            self.config, frame_hw=frame_hw,
            checkpoint=self._checkpoint_for(self.config.puck_model_name),
            device=self.device)
        return self.puck_model
