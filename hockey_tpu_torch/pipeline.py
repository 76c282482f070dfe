"""The VideoProcessor for PLAYER_DETECTION and PLAYER_TRACKING: port of the
batched loop of hockey_tpu/pipeline.py:388-474, its tracker choice
(:120-155), `unpack_tracked` (:476-502) and the two modes' branches of
`process_frame` (:261-296, :354-363).

The numeric part needs no OpenCV: `detect_frames` and `track_frames` turn
any iterable of frames into per-frame detections or tracked rows.
`process_video` reads a video, runs the same steps and draws.

PLAYER_TRACKING runs without jersey-number OCR: the reference's
no-backend path (hockey_tpu ocr/jersey.py:43-49, `digit_params=False`),
so its labels carry tracker ids only. OCR is ROADMAP.md item 4.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from .annotate.draw import make_annotators
from .annotate.smooth import SmoothAnnotator
from .core.config import (
    GOALIE_TEAM_ID,
    GOALKEEPER_CLASS_ID,
    PLAYER_CLASS_ID,
    Config,
    ProcessingMode,
)
from .core.device import resolve_device
from .models.detector import Detector, HostDetections
from .ops.nms import Detections
from .tracking.bytetrack import ByteTrack
from .tracking.device_tracker import DeviceByteTrack
from .utils.metrics import StageTimers
from .video.io import VideoInfo, batched, batched_frame_generator

PORTED_MODES = (ProcessingMode.PLAYER_DETECTION, ProcessingMode.PLAYER_TRACKING)

# (boxes (n, 4), scores (n,), classes (n,) int32, tracker_ids (n,) int32)
Tracked = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


class VideoProcessor:
    """Orchestrator of the ported modes, PLAYER_DETECTION and
    PLAYER_TRACKING; the others raise, naming ROADMAP.md.

    Tracker choice (hockey_tpu pipeline.py:120-155): with
    `config.use_device_tracker` None, tracking is fused into the detect
    step on the device on CUDA with a frame batch above 1, and runs in the
    host ByteTrack elsewhere; both get the duplicate-kill knobs."""

    def __init__(
        self,
        config: Optional[Config] = None,
        device="cuda",
        mode: ProcessingMode = ProcessingMode.PLAYER_DETECTION,
        frame_hw: Tuple[int, int] = (1080, 1920),
        checkpoint: Optional[str] = None,
        player_detector=None,
    ):
        self.mode = ProcessingMode(mode)
        if self.mode not in PORTED_MODES:
            raise NotImplementedError(
                f"mode {self.mode.value}: the port runs PLAYER_DETECTION and "
                "PLAYER_TRACKING so far; see ROADMAP.md for the slices still "
                "to come")
        self.config = config or Config()
        self.device = resolve_device(device)
        self.frame_hw = frame_hw
        self.timers = StageTimers()
        self.last_frame_result = None  # set per frame in the tracking mode
        self.last_track_batch = None   # the fused step's last raw output
        self.player_detector = player_detector or Detector(
            self.config.player_model_name, self.config, frame_hw=frame_hw,
            checkpoint=checkpoint, device=self.device)
        self.box_annotator, self.label_annotator = make_annotators(self.config)
        self.smooth_annotator = SmoothAnnotator(
            self.box_annotator, smoothing_factor=self.config.smoothing_factor,
            use_adaptive=self.config.use_adaptive_smoothing)

        self.tracker = None
        self.use_fused_tracker = False
        if self.mode == ProcessingMode.PLAYER_TRACKING:
            cfg = self.config
            fusable = hasattr(self.player_detector, "detect_track_batch")
            use_device_tracker = cfg.use_device_tracker
            if use_device_tracker is None:
                use_device_tracker = (self.device.type == "cuda" and fusable
                                      and cfg.resolved_frame_batch(self.device) > 1)
            self.use_fused_tracker = bool(use_device_tracker) and fusable
            if use_device_tracker:
                self.tracker = DeviceByteTrack.from_config(cfg, self.device)
            else:
                self.tracker = ByteTrack.from_config(cfg)
            print("PLAYER_TRACKING without jersey-number OCR (not ported yet, "
                  "ROADMAP.md item 4): labels show tracker ids; tracker: "
                  + ("fused on the device" if self.use_fused_tracker else
                     type(self.tracker).__name__))

    def _filter(self, det: HostDetections) -> HostDetections:
        """Keep {player, goalkeeper} above detection_confidence (reference
        main.py:177-195)."""
        keep = (det.classes == PLAYER_CLASS_ID) | (det.classes == GOALKEEPER_CLASS_ID)
        keep &= det.scores > self.config.detection_confidence
        return HostDetections(det.boxes[keep], det.scores[keep], det.classes[keep])

    def _detect_batch(self, frames: np.ndarray, n: int) -> List[HostDetections]:
        with self.timers.stage("detect"):
            det = Detections(*(t.cpu() for t in
                               self.player_detector.detect_batch(frames)))
            dets = [self._filter(HostDetections.from_padded(det, i))
                    for i in range(n)]
        for d in dets:
            self.timers.count("detections", len(d))
        return dets

    def _track_batch(self, frames: np.ndarray, n: int) -> List[Tracked]:
        """One batch of PLAYER_TRACKING: each of its n frames' tracked rows.
        Fused, one device step and one copy to the host; else detection in
        one batch, then the tracker frame by frame."""
        if not self.use_fused_tracker:
            rows = []
            for d in self._detect_batch(frames, n):
                with self.timers.stage("track"):
                    rows.append(self.tracker.update(d.boxes, d.scores, d.classes))
            return rows
        with self.timers.stage("detect"):
            out = self.player_detector.detect_track_batch(
                frames, self.tracker.state)
            self.tracker.state = out[-1]
            self.last_track_batch = out
            rows = unpack_tracked(out)
        return [r[:4] for r in rows[:n]]

    def detect_frames(self, frames: Iterable[np.ndarray]) -> Iterator[HostDetections]:
        """Frames (H, W, 3) uint8 -> each frame's filtered detections, run
        in device batches of `config.resolved_frame_batch`."""
        b = self.config.resolved_frame_batch(self.device)
        for batch, n in batched(iter(frames), b):
            yield from self._detect_batch(batch, n)

    def track_frames(self, frames: Iterable[np.ndarray]) -> Iterator[Tracked]:
        """Frames (H, W, 3) uint8 -> each frame's (boxes, scores, classes,
        tracker_ids) of the detections that acquired an emittable track, in
        device batches of `config.resolved_frame_batch` (PLAYER_TRACKING)."""
        if self.mode != ProcessingMode.PLAYER_TRACKING:
            raise ValueError("track_frames needs mode PLAYER_TRACKING")
        b = self.config.resolved_frame_batch(self.device)
        for batch, n in batched(iter(frames), b):
            yield from self._track_batch(batch, n)

    def process_frame(self, frame: np.ndarray,
                      det: Optional[HostDetections] = None,
                      pretracked: Optional[Tracked] = None) -> np.ndarray:
        """Draw one frame. PLAYER_DETECTION: `det`'s boxes with Player and
        Goalie labels. PLAYER_TRACKING: `pretracked` rows (else `det` goes
        through the tracker here), smoothed per tracker id, labelled '#id'
        or 'Goalie #id'."""
        if pretracked is None and det is None:
            with self.timers.stage("detect"):
                det = self._filter(self.player_detector.detect(frame))
        if self.mode == ProcessingMode.PLAYER_DETECTION:
            with self.timers.stage("annotate"):
                lookup = np.where(det.classes == GOALKEEPER_CLASS_ID,
                                  GOALIE_TEAM_ID, 0).astype(np.int32)
                labels = ["Goalie" if c == GOALKEEPER_CLASS_ID else "Player"
                          for c in det.classes]
                out = self.box_annotator.annotate(frame.copy(), det.boxes,
                                                  lookup)
                return self.label_annotator.annotate(out, det.boxes, labels, lookup)

        if pretracked is None:
            with self.timers.stage("track"):
                pretracked = self.tracker.update(det.boxes, det.scores, det.classes)
        boxes, scores, classes, tids = pretracked
        self.timers.count("tracks", len(tids))
        gmask = classes == GOALKEEPER_CLASS_ID
        labels = [("Goalie #" if g else "#") + str(tid)
                  for g, tid in zip(gmask, tids)]
        lookup = np.where(gmask, GOALIE_TEAM_ID, 0).astype(np.int32)
        self.last_frame_result = {
            "boxes": np.asarray(boxes), "scores": np.asarray(scores),
            "classes": np.asarray(classes), "tracker_ids": np.asarray(tids),
            "team_ids": lookup,
        }
        with self.timers.stage("annotate"):
            out = self.smooth_annotator.annotate(frame.copy(), boxes, tids,
                                                 scores, lookup)
            return self.label_annotator.annotate(out, boxes, labels, lookup)

    def process_video(self, source_path: str,
                      limit: Optional[int] = None) -> Iterator[np.ndarray]:
        """Annotated frames of a video: the mode's device step in batches,
        then drawing frame by frame in order."""
        b = self.config.resolved_frame_batch(self.device)
        tracking = self.mode == ProcessingMode.PLAYER_TRACKING
        for frames, n in batched_frame_generator(source_path, b, limit=limit):
            if tracking:
                for i, rows in enumerate(self._track_batch(frames, n)):
                    yield self.process_frame(frames[i], pretracked=rows)
            else:
                for i, det in enumerate(self._detect_batch(frames, n)):
                    yield self.process_frame(frames[i], det)


def unpack_tracked(out) -> List[Tuple]:
    """The fused step's output -> per-frame host rows (boxes, scores,
    classes, tids, None), keeping only detections that acquired an
    emittable track id, from the one `packed` tensor: one device-to-host
    copy per batch (hockey_tpu pipeline.py:476-491; the port's fused step
    always packs)."""
    arr = out[3].cpu().numpy()
    rows = []
    for i in range(arr.shape[0]):
        r = arr[i][arr[i, :, 6] >= 0]
        rows.append((r[:, :4], r[:, 4], r[:, 5].astype(np.int32),
                     r[:, 6].astype(np.int32), None))
    return rows


def process_video_with_display(processor: VideoProcessor, source_path: str,
                               target_path: Optional[str] = None,
                               display: bool = True,
                               limit: Optional[int] = None) -> int:
    """Write (and optionally show) the annotated video; returns the number
    of frames written (hockey_tpu pipeline.py process_video_with_display)."""
    import cv2

    from .video.io import VideoSink

    n = 0
    sink = None
    try:
        if target_path:
            sink = VideoSink(target_path,
                             VideoInfo.from_video_path(source_path)).__enter__()
        for frame in processor.process_video(source_path, limit=limit):
            if sink is not None:
                sink.write_frame(frame)
            n += 1
            if display:
                cv2.imshow("Hockey Vision", frame)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
    finally:
        if sink is not None:
            sink.__exit__()
        if display:
            cv2.destroyAllWindows()
    return n
