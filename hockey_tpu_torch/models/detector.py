"""The detection step: letterbox -> YOLOv8 -> DFL decode -> NMS -> box
un-mapping over a frame batch, optionally the team-feature branch or a
pose model's keypoints, and the fused detect + track step. Port of
hockey_tpu/models/detector.py (`HostDetections`, `_unmap_boxes`,
`_build_detect_core` as `DetectCore`, its team branch as
`team_features`, `build_detect_track_fn` as `DetectTrackStep`,
`BYTE_FLOOR`, `Detector`).

The frames cross to the device once per batch (`core.staging.upload`);
the step's constant matrices and anchors are built on the device once
(`core.device.device_constant`). NMS suppression runs in the CUDA kernel
of ops/nms_kernel.py on a CUDA device.

Every detect step's result reaches the host through one handoff: `pack`
lays it out on the device as one f32 tensor (a row [x1 y1 x2 y2 | score |
class | id | per-slot features] per detection slot, then the per-frame
block's rows; the layout is documented there), `fetch` copies it once
into a `HostBatch`. `served_model` builds every served model.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import GOALKEEPER_CLASS_ID, PLAYER_CLASS_ID, Config
from ..core.device import compute_dtype, resolve_device
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


def pack(det: Detections, ids: Optional[torch.Tensor] = None,
         feats: Optional[torch.Tensor] = None,
         block: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A detect step's batch as one f32 tensor (B, D + K, C), in a `pack`
    range, for `fetch`'s one copy. Rows 0..D-1, one per detection slot:
    [x1 y1 x2 y2 | score | class | id | feats (B, D, F), per-slot], C =
    7 + F; `id` is `ids` (the fused step's track ids, -1 where no
    emittable track holds the slot), else 0 on a valid slot and -1 on an
    empty one, and the host keeps the rows with id >= 0. Rows D.., with
    `block` (B, K, W <= C) (keypoints, W = 3): its rows, zero-padded.
    Ints and flags are exact in f32 below 2**24: host rows are bit-equal."""
    with annotate("pack"):
        if ids is None:
            ids = torch.where(det.valid, 0, -1)
        cols = [det.boxes, det.scores[..., None], det.classes[..., None],
                ids[..., None]]
        if feats is not None:
            cols.append(feats)
        rows = torch.cat([c.float() for c in cols], dim=-1)
        if block is None:
            return rows
        pad = (0, rows.shape[-1] - block.shape[-1])
        return torch.cat([rows, F.pad(block.float(), pad)], dim=1)


class HostBatch(NamedTuple):
    """`pack`'s tensor on the host (`fetch`): padded (B, D) per-slot
    arrays and the per-frame block."""

    boxes: np.ndarray            # (B, D, 4) xyxy float32
    scores: np.ndarray           # (B, D)
    classes: np.ndarray          # (B, D) int32
    ids: np.ndarray              # (B, D) int32; -1 on a slot the host drops
    feats: Optional[np.ndarray]  # (B, D, F) per-slot features, or None
    block: Optional[np.ndarray]  # (B, ...) per-frame block, or None

    @property
    def valid(self) -> np.ndarray:
        return self.ids >= 0

    def frame(self, i: int) -> Tuple:
        """Frame i's kept rows: (detections, ids (k,), features (k, F) or
        None)."""
        v = self.ids[i] >= 0
        return (HostDetections(self.boxes[i][v], self.scores[i][v],
                               self.classes[i][v]),
                self.ids[i][v], None if self.feats is None else self.feats[i][v])

    def rows(self) -> List[Tuple]:
        """`frame` of every frame, in an `unpack` range."""
        with annotate("unpack"):
            return [self.frame(i) for i in range(len(self.ids))]


def fetch(packed: torch.Tensor,
          block_shape: Optional[Tuple[int, int]] = None) -> HostBatch:
    """`pack`'s tensor -> HostBatch: the batch's one copy to the host, in a
    `fetch` range (the host's wait for the step); `block_shape` (K, W) of
    the per-frame block, if any."""
    with annotate("fetch"):
        arr = packed.cpu().numpy()
    k, w = block_shape or (0, 0)
    s = arr[:, :arr.shape[1] - k]
    return HostBatch(s[..., :4], s[..., 4], s[..., 5].astype(np.int32),
                     s[..., 6].astype(np.int32),
                     s[..., 7:] if s.shape[-1] > 7 else None,
                     arr[:, s.shape[1]:, :w] if k else None)


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

    def to_host(self, out) -> HostBatch:
        """This core's result on the host (`pack`, `fetch`): team features
        as per-slot columns, keypoints as the per-frame block."""
        if self.with_team_features:
            return fetch(pack(out[0], feats=out[1]))
        if self.with_keypoints:
            return fetch(pack(out[0], block=out[1]), tuple(out[1].shape[1:]))
        return fetch(pack(out))


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
    `pack`'s layout with the track ids as the id column, so the host needs
    one device-to-host copy per batch."""

    def __init__(self, core: DetectCore, tracker_kwargs: Dict):
        self.core, self.tracker_kwargs = core, tracker_kwargs

    def __call__(self, model: YOLOv8, frames: torch.Tensor, state: TrackState):
        out = self.core(model, frames)
        det, feats = out if self.core.with_team_features else (out, None)
        with annotate("tracker_scan"):
            state2, tids = tracker_scan(state, *tracker_inputs(det),
                                        **self.tracker_kwargs)
        return det, feats, tids, pack(det, ids=tids, feats=feats), state2


def served_model(name: str, checkpoint: Optional[str], device: torch.device,
                 dtype: torch.dtype, fuse: bool = True) -> YOLOv8:
    """The model `name` for serving: weights from `checkpoint`, else the
    JAX package's shipped ones; BN folded into `dtype` with `fuse`, else
    cast to it; channels_last on `device`."""
    path = checkpoint or shipped_weights_path(name)
    if path is None:
        raise FileNotFoundError(f"no checkpoint for {name!r}")
    model = build_model(MODEL_ZOO[name], load_params(path))
    model = fuse_for_inference(model, dtype) if fuse else model.to(dtype)
    return model.to(device, memory_format=torch.channels_last)


class Detector:
    """Host-facing detector: owns the model and the detect step.

    The model is `served_model(model_name, checkpoint, ..., fuse)` in
    `dtype` (`compute_dtype`: bf16 on CUDA, f32 on the CPU by default).
    With `with_team_features` both steps also return each box slot's 4-dim
    team feature (`team_features`); a pose model (`hockey-detection`)'s
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
        self.dtype = compute_dtype(self.device, dtype)
        self.config = config or Config()
        self.cfg = MODEL_ZOO[model_name]
        self.imgsz = imgsz or self.config.detection_imgsz
        self.conf = conf if conf is not None else self.config.detection_confidence
        self.frame_hw = frame_hw
        self.max_det = max_det or self.config.max_detections
        self.model = served_model(model_name, checkpoint, self.device,
                                  self.dtype, fuse)
        self.core = self._core(self.conf, with_team_features=with_team_features,
                               with_keypoints=self.cfg.num_keypoints > 0)
        self._track_step: Optional[DetectTrackStep] = None  # built lazily

    def _core(self, conf: float, **flags) -> DetectCore:
        """A DetectCore of this detector's sizes, dtype and Config at `conf`."""
        c = self.config
        return DetectCore(
            self.cfg, imgsz=self.imgsz, frame_hw=self.frame_hw, conf=conf,
            iou=c.nms_iou_threshold, containment=c.nms_containment_threshold,
            pre_topk=c.nms_pre_topk, max_det=self.max_det, dtype=self.dtype,
            **flags)

    def step(self, x: torch.Tensor):
        """The core's result on frames (B, H, W, 3) uint8 on the device."""
        with torch.inference_mode():
            return self.core(self.model, x)

    def detect_batch(self, frames):
        """(B, H, W, 3) uint8 (numpy or tensor) -> padded Detections on the
        detector's device; with team features, (Detections, features
        (B, D, 4)); for a pose model, (Detections, keypoints (B, K, 3))."""
        return self.step(upload(frames, self.device))

    def fetch_batch(self, frames) -> HostBatch:
        """`detect_batch`'s result on the host in one copy (`to_host`)."""
        return self.core.to_host(self.detect_batch(frames))

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
            core = self._core(min(self.conf, BYTE_FLOOR),
                              with_team_features=self.with_team_features)
            self._track_step = DetectTrackStep(core, self.tracker_kwargs())
        x = upload(frames, self.device)
        with torch.inference_mode():
            return self._track_step(self.model, x, state)

    def detect(self, frame: np.ndarray) -> HostDetections:
        """Single frame -> host-side unpadded detections (team features or
        keypoints, if any, are dropped)."""
        return self.fetch_batch(frame[None]).frame(0)[0]
