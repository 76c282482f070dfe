"""The dual step: player detection and rink keypoints over one upload of a
frame batch. Port of hockey_tpu/models/dual.py (`build_dual_fn` as
`DualStep`, `DualDetector`).

With rink keypoints on (`--rink-keypoints`, `--show-2d-map`) the
pipeline runs this step instead of the player `Detector`'s:

- the player branch is the player `DetectCore` (minimal-rectangle
  letterbox at `detection_imgsz`, YOLOv8x, decode, NMS through the CUDA
  suppression kernel, un-mapping) and, in TEAM_CLASSIFICATION, the ds = 4
  team branch;
- the rink branch letterboxes the same frames to the `rink_imgsz` square
  (the pose checkpoint's training resolution), runs the YOLOv8s-pose
  model and un-maps the best anchor's 56 keypoints; it runs no NMS.

The results go to the host in one copy per batch through the detect
steps' one handoff (models/detector.py `pack`, `fetch`): a row [x1 y1 x2
y2 | score | class | id | team features] per slot, then the 56
keypoints' rows. The step has no tracker: the
JAX package has no dual program with one, and the pipeline's tracking
modes run the host ByteTrack after it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import Config
from ..core.staging import upload
from ..ops.letterbox import letterbox_batch
from ..utils.profiling import annotate
from .detector import (DetectCore, Detector, HostBatch, best_keypoints,
                       fetch, letterbox_geometry, pack, served_model)
from .yolov8 import (MODEL_ZOO, YOLOv8, YoloConfig, decode_boxes,
                     decode_keypoints, forward_raw)


class DualStep:
    """(player model, rink model, frames (B, H, W, 3) uint8 on the device)
    -> (Detections, team features (B, D, 4) or None, keypoints (B, K, 3) in
    frame px, `pack`ed with the keypoints as the block) (hockey_tpu
    dual.py:37-115). Each rink stage is an `annotate` range: rink_letterbox,
    rink_forward, rink_decode; the player branch keeps the detect step's
    ranges, and `pack` is the last."""

    def __init__(self, core: DetectCore, rink_cfg: YoloConfig,
                 rink_imgsz: int):
        self.core, self.rink_cfg, self.rink_imgsz = core, rink_cfg, rink_imgsz
        self.rink_geometry = letterbox_geometry(*core.frame_hw, rink_imgsz,
                                                rect=False)

    def rink_keypoints(self, rink_model: YOLOv8, frames: torch.Tensor
                       ) -> torch.Tensor:
        """The rink branch: frames -> the best anchor's keypoints
        (B, K, 3) in frame px, letterboxed in the model's dtype."""
        hw = (self.rink_imgsz, self.rink_imgsz)
        dtype = next(rink_model.buffers()).dtype
        with annotate("rink_letterbox"):
            x = letterbox_batch(frames, self.rink_imgsz, dtype)
        with annotate("rink_forward"):
            raw = forward_raw(rink_model, x)
        with annotate("rink_decode"):
            _, scores = decode_boxes(raw, self.rink_cfg, hw)
            return best_keypoints(decode_keypoints(raw, self.rink_cfg, hw),
                                  scores.max(dim=-1).values, self.rink_geometry)

    def __call__(self, player_model: YOLOv8, rink_model: YOLOv8,
                 frames: torch.Tensor):
        out = self.core(player_model, frames)
        det, feats = out if self.core.with_team_features else (out, None)
        kpts = self.rink_keypoints(rink_model, frames)
        return det, feats, kpts, pack(det, feats=feats, block=kpts)


class DualDetector:
    """Player detection and rink keypoints in one step per batch; the
    player `Detector`'s `detect_batch` / `fetch_batch` / `detect` contract
    plus `last_keypoints` (hockey_tpu dual.py:118-175). `player` is the
    `Detector` of `config.player_model_name` (`checkpoint`) whose core is
    the player branch; the rink model, `config.hockey_model_name`'s
    (`rink_checkpoint`), is built by `served_model` in the same dtype."""

    def __init__(self, config: Optional[Config] = None,
                 frame_hw: Tuple[int, int] = (1080, 1920),
                 checkpoint: Optional[str] = None,
                 rink_checkpoint: Optional[str] = None,
                 with_team_features: bool = True, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        self.config = c = config or Config()
        self.with_team_features = with_team_features
        self.player = Detector(c.player_model_name, c, frame_hw=frame_hw,
                               checkpoint=checkpoint, device=device,
                               dtype=dtype,
                               with_team_features=with_team_features)
        self.rink_cfg = MODEL_ZOO[c.hockey_model_name]
        self.rink_model = served_model(c.hockey_model_name, rink_checkpoint,
                                       self.player.device, self.player.dtype)
        self.step = DualStep(self.player.core, self.rink_cfg, c.rink_imgsz)
        self.last_keypoints: Optional[np.ndarray] = None

    def run(self, frames):
        """The step on the device: (Detections, team features or None,
        keypoints (B, K, 3), packed), all on the detector's device."""
        x = upload(frames, self.player.device)
        with torch.inference_mode():
            return self.step(self.player.model, self.rink_model, x)

    def detect_batch(self, frames):
        """(B, H, W, 3) uint8 -> padded Detections on the detector's
        device, with team features (Detections, features (B, D, 4)), as
        `Detector.detect_batch`; the keypoints stay on the device."""
        det, feats = self.run(frames)[:2]
        return det if feats is None else (det, feats)

    def fetch_batch(self, frames) -> HostBatch:
        """The step's packed result on the host in one copy (`fetch`); the
        batch's keypoints (B, K, 3) go to `last_keypoints`."""
        host = fetch(self.run(frames)[3], (self.rink_cfg.num_keypoints, 3))
        self.last_keypoints = host.block
        return host

    detect = Detector.detect  # by this `fetch_batch`, so it sets last_keypoints
