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

The branches' results are packed into one (B, D * C + 3K) f32 tensor, so
the host gets them in one copy per batch. The step has no tracker: the
JAX package has no dual program with one, and the pipeline's tracking
modes run the host ByteTrack after it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..core.staging import upload
from ..ops.letterbox import letterbox_batch
from ..ops.nms import Detections
from ..utils.profiling import annotate
from .checkpoint import load_params, shipped_weights_path
from .detector import (DetectCore, HostDetections, best_keypoints,
                       letterbox_geometry)
from .layers import fuse_for_inference
from .yolov8 import (MODEL_ZOO, YOLOv8, YoloConfig, build_model, decode_boxes,
                     decode_keypoints, forward_raw)

# the packed row of one detection slot: [x1 y1 x2 y2 | score | class |
# valid | team features (4), with the team branch]
DET_COLS = 7


class DualStep:
    """(player model, rink model, frames (B, H, W, 3) uint8 on the device)
    -> (Detections, team features (B, D, 4) or None, keypoints (B, K, 3) in
    frame px, packed (B, D * C + 3K) f32) (hockey_tpu dual.py:37-115).
    Each rink stage is an `annotate` range: rink_letterbox,
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
        with annotate("pack"):
            cols = [det.boxes, det.scores[..., None],
                    det.classes.float()[..., None], det.valid.float()[..., None]]
            if feats is not None:
                cols.append(feats)
            b = frames.shape[0]
            packed = torch.cat([torch.cat(cols, dim=-1).reshape(b, -1),
                                kpts.reshape(b, -1)], dim=1)
        return det, feats, kpts, packed


def unpack_dual(packed: np.ndarray, max_det: int, num_keypoints: int):
    """The host's copy of `DualStep`'s packed (B, D * C + 3K) -> (Detections
    of CPU tensors, team features (B, D, 4) or None, keypoints (B, K, 3))."""
    b = packed.shape[0]
    rows = packed[:, :packed.shape[1] - 3 * num_keypoints].reshape(b, max_det, -1)
    kpts = packed[:, rows.shape[1] * rows.shape[2]:].reshape(b, num_keypoints, 3)
    det = Detections(torch.from_numpy(rows[..., :4].copy()),
                     torch.from_numpy(rows[..., 4].copy()),
                     torch.from_numpy(rows[..., 5].astype(np.int32)),
                     torch.from_numpy(rows[..., 6] > 0))
    feats = rows[..., DET_COLS:] if rows.shape[2] > DET_COLS else None
    return det, feats, kpts


class DualDetector:
    """Player detection and rink keypoints in one step per batch; the
    player `Detector`'s `detect_batch` / `detect` contract plus
    `last_keypoints` (hockey_tpu dual.py:118-175).

    Weights: `checkpoint` / `rink_checkpoint` if given, else the shipped
    checkpoints of `config.player_model_name` and
    `config.hockey_model_name`; BN folded, cast to `dtype` (bf16 on CUDA,
    f32 on the CPU by default)."""

    def __init__(self, config: Optional[Config] = None,
                 frame_hw: Tuple[int, int] = (1080, 1920),
                 checkpoint: Optional[str] = None,
                 rink_checkpoint: Optional[str] = None,
                 with_team_features: bool = True, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        self.config = c = config or Config()
        self.device = resolve_device(device)
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda"
                               else torch.float32)
        self.player_cfg = MODEL_ZOO[c.player_model_name]
        self.rink_cfg = MODEL_ZOO[c.hockey_model_name]
        self.with_team_features = with_team_features
        self.max_det = c.max_detections
        self.player_model = self._model(self.player_cfg, c.player_model_name,
                                        checkpoint)
        self.rink_model = self._model(self.rink_cfg, c.hockey_model_name,
                                      rink_checkpoint)
        self.core = DetectCore(
            self.player_cfg, imgsz=c.detection_imgsz, frame_hw=frame_hw,
            conf=c.detection_confidence, iou=c.nms_iou_threshold,
            containment=c.nms_containment_threshold, pre_topk=c.nms_pre_topk,
            max_det=self.max_det, dtype=self.dtype,
            with_team_features=with_team_features)
        self.step = DualStep(self.core, self.rink_cfg, c.rink_imgsz)
        self.last_keypoints: Optional[np.ndarray] = None

    def _model(self, cfg: YoloConfig, name: str, checkpoint: Optional[str]):
        path = checkpoint or shipped_weights_path(name)
        if path is None:
            raise FileNotFoundError(f"no checkpoint for {name!r}")
        model = fuse_for_inference(build_model(cfg, load_params(path)), self.dtype)
        return model.to(self.device, memory_format=torch.channels_last)

    def run(self, frames):
        """The step on the device: (Detections, team features or None,
        keypoints (B, K, 3), packed), all on the detector's device."""
        x = upload(frames, self.device)
        with torch.inference_mode():
            return self.step(self.player_model, self.rink_model, x)

    def detect_batch(self, frames):
        """(B, H, W, 3) uint8 -> padded Detections on the host (CPU
        tensors), with team features (Detections, features (B, D, 4)); the
        batch's keypoints (B, K, 3) go to `last_keypoints`. One copy from
        the device per batch."""
        packed = self.run(frames)[3].cpu().numpy()
        det, feats, self.last_keypoints = unpack_dual(
            packed, self.max_det, self.rink_cfg.num_keypoints)
        return (det, torch.from_numpy(feats.copy())) if self.with_team_features \
            else det

    def detect(self, frame: np.ndarray) -> HostDetections:
        """Single frame -> host-side unpadded detections; its keypoints go
        to `last_keypoints` (1, K, 3)."""
        out = self.detect_batch(frame[None])
        return HostDetections.from_padded(
            out if isinstance(out, Detections) else out[0], 0)
