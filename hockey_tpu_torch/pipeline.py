"""The VideoProcessor for PLAYER_DETECTION: port of the batched loop of
hockey_tpu/pipeline.py:388-447 and its PLAYER_DETECTION branch (:261-269).

The numeric part needs no OpenCV: `detect_frames` turns any iterable of
frames into per-frame filtered detections. `process_video` reads a video,
runs the same detection and draws boxes and labels.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from .annotate.draw import make_annotators
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
from .utils.metrics import StageTimers
from .video.io import VideoInfo, batched, batched_frame_generator


class VideoProcessor:
    """PLAYER_DETECTION orchestrator; other modes are later slices."""

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
        if self.mode != ProcessingMode.PLAYER_DETECTION:
            raise NotImplementedError(
                f"mode {self.mode.value}: the port runs PLAYER_DETECTION only "
                "so far; see ROADMAP.md for the slices still to come")
        self.config = config or Config()
        self.device = resolve_device(device)
        self.frame_hw = frame_hw
        self.timers = StageTimers()
        self.player_detector = player_detector or Detector(
            self.config.player_model_name, self.config, frame_hw=frame_hw,
            checkpoint=checkpoint, device=self.device)
        self.box_annotator, self.label_annotator = make_annotators(self.config)

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

    def detect_frames(self, frames: Iterable[np.ndarray]) -> Iterator[HostDetections]:
        """Frames (H, W, 3) uint8 -> each frame's filtered detections, run
        in device batches of `config.resolved_frame_batch`."""
        b = self.config.resolved_frame_batch(self.device)
        for batch, n in batched(iter(frames), b):
            yield from self._detect_batch(batch, n)

    def process_frame(self, frame: np.ndarray, det: HostDetections) -> np.ndarray:
        """Draw one frame's detections: boxes and Player/Goalie labels."""
        with self.timers.stage("annotate"):
            lookup = np.where(det.classes == GOALKEEPER_CLASS_ID,
                              GOALIE_TEAM_ID, 0).astype(np.int32)
            labels = ["Goalie" if c == GOALKEEPER_CLASS_ID else "Player"
                      for c in det.classes]
            out = self.box_annotator.annotate(frame.copy(), det.boxes, lookup)
            return self.label_annotator.annotate(out, det.boxes, labels, lookup)

    def process_video(self, source_path: str,
                      limit: Optional[int] = None) -> Iterator[np.ndarray]:
        """Annotated frames of a video: detection in device batches, then
        drawing frame by frame in order."""
        b = self.config.resolved_frame_batch(self.device)
        for frames, n in batched_frame_generator(source_path, b, limit=limit):
            for i, det in enumerate(self._detect_batch(frames, n)):
                yield self.process_frame(frames[i], det)


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
