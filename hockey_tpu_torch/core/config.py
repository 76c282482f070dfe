"""Pipeline configuration: the port's own copy of hockey_tpu/core/config.py.

Field names and defaults are the JAX package's (which mirror the reference
`Config`, hockey/main.py:20-59). The one behavioural difference is
`resolved_frame_batch`, which is keyed on the torch device instead of the
JAX backend and picks a batch that fits a YOLOv8x activation footprint at
736x1280 on one card.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

import torch


class ProcessingMode(str, enum.Enum):
    """CLI processing modes (reference README.md:134-139)."""

    PLAYER_DETECTION = "PLAYER_DETECTION"
    PUCK_DETECTION = "PUCK_DETECTION"
    PLAYER_TRACKING = "PLAYER_TRACKING"
    TEAM_CLASSIFICATION = "TEAM_CLASSIFICATION"


# Class ids (reference hockey/main.py:357-359).
PLAYER_CLASS_ID = 0
GOALKEEPER_CLASS_ID = 1
# Team id assigned to goalies (reference hockey/main.py:284).
GOALIE_TEAM_ID = 2

# Frames per detection batch when `frame_batch` is 0. On CUDA: YOLOv8x at
# 736x1280 holds ~38 MB of bf16 stem activations per frame, so 8 frames
# keep the largest layer's working set well under a gigabyte.
CUDA_FRAME_BATCH = 8


@dataclasses.dataclass
class Config:
    """Pipeline configuration (defaults of hockey_tpu.core.config.Config)."""

    # --- Model identifiers.
    player_model_name: str = "hockey-player-detection"
    hockey_model_name: str = "hockey-detection"
    puck_model_name: str = "hockey-puck-detection"

    # --- Detection (reference main.py:28-29).
    detection_imgsz: int = 1280
    rink_imgsz: int = 512
    detection_confidence: float = 0.4

    # --- Tracking (reference main.py:32-36; 0.95 is the JAX package's
    # measured match gate, COMPAT #28).
    track_activation_threshold: float = 0.25
    lost_track_buffer: int = 30
    minimum_matching_threshold: float = 0.95
    frame_rate: int = 30
    minimum_consecutive_frames: int = 2

    # --- Team classification sampling (reference main.py:39-41).
    initialization_stride: int = 10
    max_initialization_frames: int = 20
    min_players_for_selection: int = 6

    # --- Annotation smoothing (reference main.py:44-45).
    smoothing_factor: float = 0.3
    use_adaptive_smoothing: bool = True

    # --- Visualization (reference main.py:48-51,59).
    team_colors: Optional[List[str]] = None
    annotation_thickness: int = 2
    label_text_scale: float = 0.6
    label_text_thickness: int = 2
    annotator_style: str = "box"

    # --- Rink keypoints (reference main.py:54-55).
    keypoint_confidence_threshold: float = 0.3
    keypoint_radius: int = 10

    # --- Puck detection via slicing.
    puck_slice_size: int = 640
    puck_slice_overlap: float = 0.2
    puck_confidence: float = 0.25
    puck_trail_length: int = 30
    puck_player_demote: float = 0.0
    puck_demote_foot_band: float = 0.2

    # --- Device knobs (no reference counterpart).
    frame_batch: int = 0               # frames per device step; 0 = auto
    max_detections: int = 64           # padded post-NMS capacity
    nms_pre_topk: int = 256            # candidates entering NMS
    nms_iou_threshold: float = 0.45    # ultralytics default
    # suppress partial-duplicate boxes by intersection-over-min-area as
    # well as by IoU (COMPAT #26); 0 = pure-IoU ultralytics contract
    nms_containment_threshold: float = 0.5
    duplicate_kill_iomin: float = 0.55
    lost_dup_kill_iomin: float = 0.55
    max_tracks: int = 128
    compute_dtype: str = "bfloat16"
    use_device_tracker: Optional[bool] = None

    def __post_init__(self) -> None:
        if self.team_colors is None:
            # Team1, Team2, Goalies (reference main.py:59).
            self.team_colors = ["#FF1493", "#00BFFF", "#FF6347"]

    def resolved_frame_batch(self, device="cuda") -> int:
        """frame_batch, with 0 = auto: CUDA_FRAME_BATCH on a CUDA device,
        1 (frame-sequential) on the CPU."""
        if self.frame_batch > 0:
            return self.frame_batch
        return CUDA_FRAME_BATCH if torch.device(device).type == "cuda" else 1


def hex_to_bgr(hex_color: str) -> Tuple[int, int, int]:
    """'#RRGGBB' -> (B, G, R) for OpenCV drawing."""
    h = hex_color.lstrip("#")
    r, g, b = int(h[0:2], 16), int(h[2:4], 16), int(h[4:6], 16)
    return (b, g, r)
