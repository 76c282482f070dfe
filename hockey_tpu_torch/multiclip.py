"""Multi-clip batch processing: port of hockey_tpu/multiclip.py.

K clips run in lockstep: each frame row (frame t of every clip) is one
`fetch_batch` of B = K frames through ONE shared `Detector`, so one card
serves many games with one set of weights and one batch per step. A clip
that has ended repeats its last frame to keep the batch's shape. Each clip
has its own VideoProcessor (sharing the detector) for tracking, teams and
drawing, so no state crosses clips; in TEAM_CLASSIFICATION each clip's
team classifier is fitted on its own frames first. All clips must share
one resolution.

`run(targets)` reads the clips from their files and writes annotated
videos (OpenCV); `run_frames(clips)` takes K iterables of frames and
yields each clip's numbers without drawing, so it runs where OpenCV is
absent. The clips' trackers are their processors' (`config`'s
`use_device_tracker`; by default the sequential DeviceByteTrack on CUDA
and the host ByteTrack on the CPU, stepped frame by frame after the
shared detection).
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .core.config import Config, ProcessingMode
from .core.device import resolve_device
from .models.detector import Detector, HostDetections
from .pipeline import VideoProcessor
from .video.io import VideoInfo, VideoSink, frame_generator


class MultiClipProcessor:
    """Clips from files (`sources`), or, for `run_frames`, `n_clips` clips
    of `frame_hw`."""

    def __init__(
        self,
        sources: Sequence[str] = (),
        config: Optional[Config] = None,
        mode: ProcessingMode = ProcessingMode.PLAYER_TRACKING,
        team_names: Optional[Tuple[str, str]] = None,
        checkpoint: Optional[str] = None,
        player_detector=None,
        device="cuda",
        frame_hw: Optional[Tuple[int, int]] = None,
        n_clips: Optional[int] = None,
    ):
        self.sources = list(sources)
        self.config = config or Config()
        self.mode = ProcessingMode(mode)
        self.device = resolve_device(device)
        self.infos: List[VideoInfo] = []
        if self.sources:
            self.infos = [VideoInfo.from_video_path(s) for s in self.sources]
            hw = {(i.height, i.width) for i in self.infos}
            if len(hw) != 1:
                raise ValueError(f"all clips must share a resolution, got {hw}")
            frame_hw = next(iter(hw))
            n_clips = len(self.sources)
        if not n_clips or frame_hw is None:
            raise ValueError("need source clips, or n_clips and frame_hw")
        self.n_clips, self.frame_hw = n_clips, tuple(frame_hw)
        # ONE detector: one set of weights, one batch per frame row
        self.detector = player_detector or Detector(
            self.config.player_model_name, self.config, frame_hw=self.frame_hw,
            checkpoint=checkpoint, device=self.device)
        self.processors: List[VideoProcessor] = [
            VideoProcessor(config=self.config, device=self.device, mode=self.mode,
                           frame_hw=self.frame_hw, team_names=team_names,
                           player_detector=self.detector)
            for _ in range(n_clips)]

    def _lockstep(self, clips: Sequence[Iterable[np.ndarray]],
                  limit_frames: Optional[int], counts: List[int]
                  ) -> Iterator[Tuple[int, np.ndarray, HostDetections]]:
        """(clip, frame, its filtered detections), row by row: one
        `fetch_batch` (detection and one copy to the host) over the K
        clips' next frames per row; `counts` holds the frames yielded per
        clip."""
        if len(clips) != self.n_clips:
            raise ValueError(f"{len(clips)} clips for {self.n_clips} processors")
        gens = [iter(c) for c in clips]
        live = [True] * self.n_clips
        # zeros until a clip's first frame, so a clip that yields nothing
        # leaves no hole in the batch
        frames = [np.zeros((*self.frame_hw, 3), np.uint8)] * self.n_clips
        while any(live):
            if limit_frames is not None and all(
                    c >= limit_frames or not alive for c, alive in zip(counts, live)):
                return
            for i, g in enumerate(gens):
                if live[i]:
                    nxt = next(g, None)
                    if nxt is None:
                        live[i] = False
                    elif nxt.shape[:2] != self.frame_hw:
                        raise ValueError(f"clip {i}: frame {nxt.shape[:2]}, "
                                         f"not {self.frame_hw}")
                    else:
                        frames[i] = nxt
            if not any(live):
                return
            host = self.detector.fetch_batch(np.stack(frames))
            for i, p in enumerate(self.processors):
                if not live[i] or (limit_frames is not None
                                   and counts[i] >= limit_frames):
                    continue
                counts[i] += 1
                yield i, frames[i], p._filter(host.frame(i)[0])

    def run(self, targets: Optional[Sequence[Optional[str]]] = None,
            limit_frames: Optional[int] = None) -> List[int]:
        """The clips of `sources` in lockstep, each annotated frame written
        to its target (None: not written); returns the frames per clip."""
        targets = targets or [None] * self.n_clips
        if self.mode == ProcessingMode.TEAM_CLASSIFICATION:
            for src, p in zip(self.sources, self.processors):
                p.initialize_team_classifier(src)
        sinks = [VideoSink(t, info).__enter__() if t else None
                 for t, info in zip(targets, self.infos)]
        counts = [0] * self.n_clips
        try:
            for i, frame, det in self._lockstep(
                    [frame_generator(s) for s in self.sources], limit_frames, counts):
                out = self.processors[i].process_frame(frame, det)
                if sinks[i] is not None:
                    sinks[i].write_frame(out)
        finally:
            for s in sinks:
                if s is not None:
                    s.__exit__()
        return counts

    def run_frames(self, clips: Sequence[Iterable[np.ndarray]],
                   limit_frames: Optional[int] = None
                   ) -> Iterator[Tuple[int, object]]:
        """K iterables of (H, W, 3) uint8 frames -> (clip, result) in
        lockstep, without drawing: in PLAYER_DETECTION the frame's filtered
        HostDetections, in the tracking modes its `last_frame_result`
        (boxes, scores, classes, tracker_ids, team_ids). In
        TEAM_CLASSIFICATION each clip's classifier is first fitted on the
        clip (`fit_teams`), which reads it twice: pass sequences."""
        if self.mode == ProcessingMode.PUCK_DETECTION:
            raise ValueError("run_frames serves the player modes")
        if self.mode == ProcessingMode.TEAM_CLASSIFICATION:
            for p, c in zip(self.processors, clips):
                p.fit_teams(iter(c))
        for i, frame, det in self._lockstep(clips, limit_frames, [0] * self.n_clips):
            p = self.processors[i]
            if self.mode == ProcessingMode.PLAYER_DETECTION:
                yield i, det
            else:
                p._tracked_result(frame, det)
                yield i, p.last_frame_result
