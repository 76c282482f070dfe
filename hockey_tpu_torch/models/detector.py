"""The detection step: letterbox -> YOLOv8 -> DFL decode -> NMS -> box
un-mapping over a frame batch, optionally the team-feature branch or a
pose model's keypoints, and the fused detect + track step. Port of
hockey_tpu/models/detector.py (`HostDetections`, `_unmap_boxes`,
`_build_detect_core` as `DetectCore`, its team branch as
`team_features`, `build_detect_track_fn` as `DetectTrackStep`,
`BYTE_FLOOR`, `Detector`).

The frames cross to the device once per batch and the fixed-size padded
detections (or, fused, the packed detections, track ids and team
features) come back once; the step's constant matrices and anchors are
built on the device once (`core.device.device_constant`). NMS suppression runs
in the CUDA kernel of ops/nms_kernel.py on a CUDA device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.config import GOALKEEPER_CLASS_ID, PLAYER_CLASS_ID, Config
from ..core.device import resolve_device
from ..core.staging import upload
from ..ops.crop_resize import crop_and_resize_mm
from ..ops.letterbox import (letterbox_batch, letterbox_params,
                             letterbox_rect_batch, rect_letterbox_params,
                             rect_shape, resize_batch)
from ..ops.nms import Candidates, Detections, nms_candidates, nms_select
from ..ops.nms_kernel import suppress
from ..teams.base import CROP_H, CROP_W
from ..teams.features import color_prior_masks, segmentation_features
from ..tracking.device_tracker import (TrackState, step_kwargs,
                                       tracker_scan)
from ..utils.profiling import annotate
from .checkpoint import load_params, shipped_weights_path
from .layers import fuse_for_inference
from .yolov8 import (MODEL_ZOO, YOLOv8, YoloConfig, build_model, decode_boxes,
                     decode_keypoints, forward_raw)

# ByteTrack's low-score floor (the tracker's stage-2 band is [BYTE_FLOOR,
# activation)); the fused tracking path floors its NMS here
BYTE_FLOOR = 0.1
# the team branch crops from frames downscaled by this factor: colour
# statistics need no full resolution (hockey_tpu detector.py:140)
TEAM_DS = 4


class HostDetections(NamedTuple):
    """Numpy view of one frame's detections in original-frame coordinates."""

    boxes: np.ndarray    # (n, 4) xyxy float32
    scores: np.ndarray   # (n,)
    classes: np.ndarray  # (n,) int32

    def __len__(self) -> int:
        return len(self.boxes)

    @staticmethod
    def from_padded(det: Detections, i: int) -> "HostDetections":
        valid = det.valid[i].cpu().numpy()
        return HostDetections(
            boxes=det.boxes[i].cpu().numpy()[valid],
            scores=det.scores[i].cpu().numpy()[valid],
            classes=det.classes[i].cpu().numpy()[valid],
        )


def letterbox_geometry(h: int, w: int, imgsz: int, rect: bool
                       ) -> Tuple[float, int, int]:
    """(ratio, pad_top, pad_left) of the minimal-rectangle (`rect`) or the
    square letterbox of an (h, w) frame at `imgsz`."""
    if rect:
        r, _, _, pad_top, pad_left, _, _ = rect_letterbox_params(h, w, imgsz)
    else:
        r, _, _, pad_top, pad_left = letterbox_params(h, w, imgsz)
    return r, pad_top, pad_left


def _unmap_boxes(boxes: torch.Tensor, h: int, w: int, imgsz: int,
                 rect: bool = True) -> torch.Tensor:
    """Letterboxed xyxy -> original-frame xyxy, clipped to the frame
    (hockey_tpu detector.py:63-72)."""
    r, pad_top, pad_left = letterbox_geometry(h, w, imgsz, rect)
    x = torch.clamp((boxes[..., 0::2] - pad_left) / r, 0.0, w)
    y = torch.clamp((boxes[..., 1::2] - pad_top) / r, 0.0, h)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def team_features(frames: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """The fused team branch (hockey_tpu detector.py:128-154): frames
    (B, H, W, 3) uint8 and padded boxes (B, D, 4) in frame pixels ->
    (B, D, 4) f32 segmentation features, one per box slot.

    The frames are resized by 1/TEAM_DS in f32; every slot's box / TEAM_DS
    is cropped from its frame by interpolation matrices to 128x64, masked
    by the colour prior and reduced to [white_ratio, dominant_hue,
    saturation, brightness]. All B * D crops go at once (the JAX package maps over the
    frames to save TPU memory), with no host sync; an empty slot gets the
    under-100-pixel defaults."""
    b, h, w, _ = frames.shape
    d = boxes.shape[1]
    small = resize_batch(frames, (h // TEAM_DS, w // TEAM_DS), torch.float32)
    crops = crop_and_resize_mm(small, boxes.float() / TEAM_DS, (CROP_H, CROP_W))
    crops = crops.reshape(b * d, CROP_H, CROP_W, 3)
    return segmentation_features(crops, color_prior_masks(crops)).reshape(b, d, 4)


def best_keypoints(kpts: torch.Tensor, max_scores: torch.Tensor,
                   geometry: Tuple[float, int, int]) -> torch.Tensor:
    """A pose model's keypoints of each frame's best anchor: kpts
    (B, A, K, 3) in letterboxed px and max_scores (B, A) -> (B, K, 3) in
    frame px, un-mapped by `geometry` (ratio, pad_top, pad_left) and not
    clipped. There is one rink per frame, so the anchor with the highest
    score stands for it (hockey_tpu detector.py:156-172, dual.py:449-458);
    ties go to the lower anchor, as jnp.argmax breaks them."""
    r, pad_top, pad_left = geometry
    best = torch.argmax(max_scores, dim=1)
    k = kpts[torch.arange(kpts.shape[0], device=kpts.device), best]
    return torch.cat([(k[..., 0:1] - pad_left) / r, (k[..., 1:2] - pad_top) / r,
                      k[..., 2:]], dim=-1)


class DetectCore:
    """(model, frames (B, H, W, 3) uint8 on the device) -> padded
    Detections in original-frame coordinates; with `with_team_features`
    (Detections, team features (B, D, 4)), else with `with_keypoints`
    (Detections, the best anchor's keypoints (B, K, 3) in frame px)
    (hockey_tpu detector.py:75-175). With `rect` (the default) frames are
    letterboxed to the minimal stride-32 rectangle (736x1280 for 1080p at
    1280), as ultralytics predict does; without it, to the imgsz square.

    The step is two halves around the suppression kernel:
    `candidates` (letterbox -> forward -> decode -> class max -> top-K and
    suppression matrix) and `finish` (selection and un-mapping of the kept
    set). Each stage is an `annotate` range (utils/profiling.py), so a
    profiler trace splits the step by stage."""

    def __init__(self, cfg: YoloConfig, *, imgsz: int,
                 frame_hw: Tuple[int, int], conf: float, iou: float = 0.45,
                 containment: float = 0.0, pre_topk: int = 256,
                 max_det: int = 64, dtype=torch.bfloat16,
                 with_team_features: bool = False,
                 with_keypoints: bool = False, rect: bool = True):
        self.cfg, self.imgsz, self.frame_hw = cfg, imgsz, frame_hw
        self.with_team_features = with_team_features
        self.with_keypoints = with_keypoints
        self.conf, self.iou, self.containment = conf, iou, containment
        self.pre_topk, self.max_det, self.dtype = pre_topk, max_det, dtype
        self.rect = rect
        self.in_hw = rect_shape(*frame_hw, imgsz) if rect else (imgsz, imgsz)

    def _decode(self, model: YOLOv8, frames: torch.Tensor):
        """(raw head maps, boxes (B, A, 4), max scores (B, A), classes)."""
        with annotate("letterbox"):
            if self.rect:
                x = letterbox_rect_batch(frames, self.imgsz, 32, self.dtype)
            else:
                x = letterbox_batch(frames, self.imgsz, self.dtype)
        with annotate("forward"):
            raw = forward_raw(model, x)
        with annotate("decode"):
            boxes, scores = decode_boxes(raw, self.cfg, self.in_hw)
            max_scores, classes = torch.max(scores, dim=-1)
        return raw, boxes, max_scores, classes

    def _candidates(self, boxes, max_scores, classes) -> Candidates:
        with annotate("nms_candidates"):
            return nms_candidates(
                boxes, max_scores, classes.int(), score_threshold=self.conf,
                iou_threshold=self.iou, containment_threshold=self.containment,
                pre_topk=self.pre_topk)

    def candidates(self, model: YOLOv8, frames: torch.Tensor) -> Candidates:
        return self._candidates(*self._decode(model, frames)[1:])

    def finish(self, cand: Candidates, keep: torch.Tensor) -> Detections:
        with annotate("nms_select_unmap"):
            det = nms_select(cand, keep, score_threshold=self.conf,
                             max_det=self.max_det)
            return det._replace(boxes=_unmap_boxes(
                det.boxes, *self.frame_hw, self.imgsz, self.rect))

    def __call__(self, model: YOLOv8, frames: torch.Tensor):
        raw, *decoded = self._decode(model, frames)
        c = self._candidates(*decoded)
        with annotate("nms_suppress"):
            keep = suppress(c.matrix, c.keep0, c.thr)
        det = self.finish(c, keep)
        if self.with_team_features:
            with annotate("team_features"):
                return det, team_features(frames, det.boxes)
        if self.with_keypoints:
            with annotate("best_keypoints"):
                geometry = letterbox_geometry(*self.frame_hw, self.imgsz,
                                              self.rect)
                return det, best_keypoints(
                    decode_keypoints(raw, self.cfg, self.in_hw), decoded[1],
                    geometry)
        return det


def tracker_inputs(det: Detections):
    """(boxes, scores, classes, valid) that the fused step gives the
    tracker: `det` with `valid` narrowed to {player, goalkeeper}, the
    class filter of the reference's detection (main.py:177-195)."""
    cls_ok = (det.classes == PLAYER_CLASS_ID) | (det.classes == GOALKEEPER_CLASS_ID)
    return det.boxes, det.scores, det.classes, det.valid & cls_ok


class DetectTrackStep:
    """The fused step (hockey_tpu detector.py:184-230): `core` (a
    DetectCore) on a frame batch, then `tracker_scan` over the batch's
    frames on the device, on `tracker_inputs`. (model, frames, TrackState)
    -> (Detections, team features (B, D, 4) or None, det_track_ids (B, D)
    int32, packed (B, D, 7 or 11) f32, new TrackState); `packed` is
    [boxes | score | class | track_id | features], so the host needs one
    device-to-host copy per batch."""

    def __init__(self, core: DetectCore, tracker_kwargs: Dict):
        self.core, self.tracker_kwargs = core, tracker_kwargs

    def __call__(self, model: YOLOv8, frames: torch.Tensor, state: TrackState):
        out = self.core(model, frames)
        det, feats = out if self.core.with_team_features else (out, None)
        with annotate("tracker_scan"):
            state2, tids = tracker_scan(state, *tracker_inputs(det),
                                        **self.tracker_kwargs)
        with annotate("pack"):
            cols = [det.boxes, det.scores[..., None],
                    det.classes.float()[..., None], tids.float()[..., None]]
            if feats is not None:
                cols.append(feats)
            packed = torch.cat(cols, dim=-1)
        return det, feats, tids, packed, state2


class Detector:
    """Host-facing detector: owns the model and the detect step.

    Weights: `checkpoint` if given, else the JAX package's shipped
    checkpoint for `model_name`. `fuse` folds BN; the model runs in
    `dtype` (bf16 on CUDA, f32 on the CPU by default). With
    `with_team_features` both steps also return each box slot's 4-dim team
    feature (`team_features`); a pose model (`hockey-detection`)'s
    `detect_batch` also returns its best anchor's keypoints."""

    def __init__(
        self,
        model_name: str,
        config: Optional[Config] = None,
        *,
        frame_hw: Tuple[int, int] = (1080, 1920),
        checkpoint: Optional[str] = None,
        imgsz: Optional[int] = None,
        conf: Optional[float] = None,
        max_det: Optional[int] = None,
        fuse: bool = True,
        device="cuda",
        dtype: Optional[torch.dtype] = None,
        with_team_features: bool = False,
    ):
        self.with_team_features = with_team_features
        self.device = resolve_device(device)
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda"
                               else torch.float32)
        self.config = config or Config()
        self.cfg = MODEL_ZOO[model_name]
        self.imgsz = imgsz or self.config.detection_imgsz
        self.conf = conf if conf is not None else self.config.detection_confidence
        self.frame_hw = frame_hw
        self.max_det = max_det or self.config.max_detections
        path = checkpoint or shipped_weights_path(model_name)
        if path is None:
            raise FileNotFoundError(f"no checkpoint for {model_name!r}")
        model = build_model(self.cfg, load_params(path))
        model = fuse_for_inference(model, self.dtype) if fuse else model.to(self.dtype)
        self.model = model.to(self.device, memory_format=torch.channels_last)
        self.core = DetectCore(
            self.cfg,
            imgsz=self.imgsz,
            frame_hw=frame_hw,
            conf=self.conf,
            iou=self.config.nms_iou_threshold,
            containment=self.config.nms_containment_threshold,
            pre_topk=self.config.nms_pre_topk,
            max_det=self.max_det,
            dtype=self.dtype,
            with_team_features=with_team_features,
            with_keypoints=self.cfg.num_keypoints > 0,
        )
        self._track_step: Optional[DetectTrackStep] = None  # built lazily

    def detect_batch(self, frames):
        """(B, H, W, 3) uint8 (numpy or tensor) -> padded Detections on the
        detector's device; with team features, (Detections, features
        (B, D, 4)); for a pose model, (Detections, keypoints (B, K, 3))."""
        x = upload(frames, self.device)
        with torch.inference_mode():
            return self.core(self.model, x)

    def tracker_kwargs(self) -> Dict:
        """The fused tracker's settings (hockey_tpu detector.py:316-327):
        the Config's, with track initiation at max(activation, conf)."""
        return step_kwargs(self.config, activation_thresh=max(
            self.config.track_activation_threshold, self.conf))

    def detect_track_batch(self, frames, state: TrackState):
        """Fused detection + tracking over a frame batch: (B, H, W, 3) uint8
        and the TrackState -> (Detections, team features (B, D, 4) or None,
        det_track_ids (B, D), packed (B, D, 7 or 11), new TrackState), all
        on the detector's device.

        ByteTrack's second stage associates low-score detections (0.1 up
        to the track-start threshold) to existing tracks, so this step
        floors NMS at BYTE_FLOOR and keeps track initiation at the
        reference's effective threshold max(activation, conf)
        (hockey_tpu detector.py:301-315)."""
        if self._track_step is None:
            c = self.config
            core = DetectCore(
                self.cfg, imgsz=self.imgsz, frame_hw=self.frame_hw,
                conf=min(self.conf, BYTE_FLOOR), iou=c.nms_iou_threshold,
                containment=c.nms_containment_threshold,
                pre_topk=c.nms_pre_topk, max_det=self.max_det,
                dtype=self.dtype, with_team_features=self.with_team_features)
            self._track_step = DetectTrackStep(core, self.tracker_kwargs())
        x = upload(frames, self.device)
        with torch.inference_mode():
            return self._track_step(self.model, x, state)

    def detect(self, frame: np.ndarray) -> HostDetections:
        """Single frame -> host-side unpadded detections (team features or
        keypoints, if any, are dropped)."""
        out = self.detect_batch(frame[None])
        return HostDetections.from_padded(
            out if isinstance(out, Detections) else out[0], 0)
