"""The VideoProcessor: port of hockey_tpu/pipeline.py for all four modes,
PLAYER_DETECTION, PLAYER_TRACKING (with jersey-number OCR),
TEAM_CLASSIFICATION (the reference's main path and the default mode) and
PUCK_DETECTION: the batched loop (:388-474), the tracker choice
(:120-155), the OCR reader (:164-168), the puck pipeline (:110-116,
404-420), the one-time team fit (`initialize_team_classifier`, :194-233),
the modes' branches of `process_frame` (:250-363) and `unpack_tracked`
(:476-502).

The numeric part needs no OpenCV: `detect_frames`, `track_frames`,
`classify_frames` and `puck_frames` turn any iterable of frames into
per-frame results, and `fit_teams` fits the team classifier on frames.
`process_video` reads a video (its batches decoded on a background
thread, `video/io.py:prefetched`), runs the same steps and draws; it can
start at a frame without the team fit, to resume a run saved by
`core/session.py`.

TEAM_CLASSIFICATION takes one of three routes, as in the JAX package:
- fused: on CUDA with a frame batch above 1, one device step per batch
  (detect, NMS kernel, `tracker_scan`, team features) and one copy of the
  packed (B, D, 11) result to the host;
- batched with the host ByteTrack: detections and team features in one
  device step per batch, the tracker frame by frame, features joined to
  the tracked rows through `tracker.last_indices`;
- frame-sequential (frame batch 1, the CPU's default): detection per
  frame, then crops sampled from the frame on the device for the tracked
  players (`predict_from_frame`).
PLAYER_TRACKING takes the first two routes without the team features;
its labels carry the jersey number that `ocr/jersey.py` has read for a
track. PUCK_DETECTION runs the sliced puck detector in batches of up to
16 frames (frame by frame at frame batch 1) and the puck tracker on the
host.

Rink keypoints and the 2D map (`enable_rink_keypoints`, `show_2d_map`;
hockey_tpu pipeline.py:47-108, 330-384): outside PUCK_DETECTION the
player detector becomes the dual step (models/dual.py: player branch and
rink pose model over one upload, batches of at most 32 frames), which has
no fused tracker, so the tracking modes run the host ByteTrack after it;
with an injected player detector a separate `RinkKeypointDetector` reads
the keypoints, once per batch. Each frame's keypoints above
`keypoint_confidence_threshold` feed the calibrator (with `show_2d_map`),
whose stabilised homography draws the map. `process_frame` draws the
keypoints first and gives the calibrator's motion probe that drawn frame,
as the JAX package does; the numeric entry points draw nothing and give
it the raw frame. PUCK_DETECTION ignores both options: the JAX package
builds the rink detector in that mode and never runs it.

On CUDA every frame batch (`_batches`, `detect_frames`, `fit_teams`) is
stacked into page-locked memory (core/staging.py `stage`), from which the
detect steps upload it without a host wait.

Every route's step reaches the host through one handoff
(models/detector.py `pack`, `fetch`): one f32 tensor, a row [x1 y1 x2 y2 |
score | class | id | team features] per slot (id: the fused step's track
id, else 0; -1 on a slot the host drops), then the dual step's keypoints;
one copy a batch (the detector's `fetch_batch`, `unpack_tracked`).

Under a `torch.profiler` profile every `StageTimers` stage is a range of
its name (`puck_track` is the puck tracker's), and inside `detect` that
copy is a `fetch` range (the host's wait for the step) and its split into
per-frame rows (`HostBatch.rows`) an `unpack` range.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple

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
from .core.staging import stage
from .homography.calibrator import CalibratorState
from .homography.keypoints import RinkKeypointDetector, keypoints_from_array
from .models.detector import Detector, HostDetections, fetch
from .models.dual import DualDetector
from .ocr.jersey import JerseyNumberReader
from .rinkmap.renderer import RinkRenderer, bottom_center_anchors
from .slicing.sahi import PuckPipeline
from .teams.base import host_crops
from .teams.facade import TeamClassifier
from .tracking.bytetrack import ByteTrack
from .tracking.device_tracker import DeviceByteTrack
from .ui.team_selector import InteractiveTeamSelector
from .utils.metrics import StageTimers
from .video.io import VideoInfo, VideoSink, batched, frame_generator, prefetched

_TRACKING_MODES = (ProcessingMode.PLAYER_TRACKING,
                   ProcessingMode.TEAM_CLASSIFICATION)
# PUCK_DETECTION's frames per device step at most: each frame is T tiles
# (hockey_tpu pipeline.py:404-410)
PUCK_MAX_BATCH = 16
# the dual step's frames per batch at most (hockey_tpu pipeline.py:398-402)
DUAL_MAX_BATCH = 32
# homography_tier gauge of the stabiliser's tier
_TIER_GAUGE = {"fine": 2.0, "coarse": 1.0}

# (boxes (n, 4), scores (n,), classes (n,) int32, tracker_ids (n,) int32)
Tracked = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


class PuckResult(NamedTuple):
    """One frame of PUCK_DETECTION: the merged detections, the tracker's
    smoothed position and the centre of the detection it selected (None
    where it has none)."""

    boxes: np.ndarray    # (n, 4) xyxy in frame pixels, n <= 4
    scores: np.ndarray   # (n,)
    center: Optional[Tuple[float, float]]
    detection: Optional[Tuple[float, float]]


class VideoProcessor:
    """Orchestrator of the four modes.

    Tracker choice (hockey_tpu pipeline.py:120-155), in PLAYER_TRACKING
    and TEAM_CLASSIFICATION: with `config.use_device_tracker` None,
    tracking is fused into the detect step on the device on CUDA with a
    frame batch above 1, and runs in the host ByteTrack elsewhere; both get
    the duplicate-kill knobs. In TEAM_CLASSIFICATION the detector also
    computes each detection's team features in its step. With rink
    keypoints on, the dual step has no fused tracker: the host ByteTrack
    runs (see the module's docstring)."""

    def __init__(
        self,
        config: Optional[Config] = None,
        device="cuda",
        mode: ProcessingMode = ProcessingMode.TEAM_CLASSIFICATION,
        frame_hw: Tuple[int, int] = (1080, 1920),
        checkpoint: Optional[str] = None,
        puck_checkpoint: Optional[str] = None,
        team_names: Optional[Tuple[str, str]] = None,
        player_detector=None,
        dtype=None,
        enable_rink_keypoints: bool = False,
        show_2d_map: bool = False,
        rink_checkpoint: Optional[str] = None,
        calibration_profile: Optional[str] = None,
    ):
        """`dtype`: the detectors' compute type (default bf16 on CUDA, f32
        on the CPU). `show_2d_map` implies the rink keypoints;
        `calibration_profile` is a saved calibrator profile to start from."""
        self.mode = ProcessingMode(mode)
        self.config = config or Config()
        self.device = resolve_device(device)
        self.frame_hw = frame_hw
        self.timers = StageTimers()
        # on CUDA every frame batch is stacked into page-locked memory,
        # which the detect steps upload without a host wait
        # (core/staging.py)
        self._stack = stage if self.device.type == "cuda" else np.stack
        self.last_frame_result = None  # set per frame in the tracking modes
        self.last_track_batch = None   # the fused step's last raw output
        teams = self.mode == ProcessingMode.TEAM_CLASSIFICATION
        want_rink = (enable_rink_keypoints or show_2d_map) \
            and self.mode != ProcessingMode.PUCK_DETECTION
        self.use_dual = want_rink and player_detector is None
        self.rink_detector = None
        self.last_keypoints = None  # the last frame's RinkKeypoints
        self.puck_pipeline = None
        if self.mode == ProcessingMode.PUCK_DETECTION:
            # the JAX VideoProcessor also builds the YOLOv8x player
            # detector in this mode and never runs it; the port does not
            # build it (the puck pipeline builds its own where player
            # demotion is on)
            self.player_detector = None
            self.puck_pipeline = PuckPipeline(
                self.config, frame_hw=frame_hw, checkpoint=puck_checkpoint,
                device=self.device, dtype=dtype)
        elif self.use_dual:
            self.player_detector = DualDetector(
                self.config, frame_hw=frame_hw, checkpoint=checkpoint,
                rink_checkpoint=rink_checkpoint, with_team_features=teams,
                device=self.device, dtype=dtype)
            print("Rink keypoint detection enabled (dual step)")
        else:
            self.player_detector = player_detector or Detector(
                self.config.player_model_name, self.config, frame_hw=frame_hw,
                checkpoint=checkpoint, device=self.device, dtype=dtype,
                with_team_features=teams)
            if want_rink:
                self.rink_detector = RinkKeypointDetector(
                    self.config.hockey_model_name, self.config,
                    frame_hw=frame_hw, checkpoint=rink_checkpoint,
                    device=self.device, dtype=dtype)
                print("Rink keypoint detection enabled")
        self.show_2d_map = show_2d_map
        self.rink_renderer = self.calibrator = None
        if show_2d_map:
            self.rink_renderer = RinkRenderer(config=self.config)
            self.calibrator = CalibratorState(frame_hw=frame_hw)
            if calibration_profile:
                self.calibrator.load_profile(calibration_profile)
        self.box_annotator, self.label_annotator = make_annotators(self.config)
        self.smooth_annotator = SmoothAnnotator(
            self.box_annotator, smoothing_factor=self.config.smoothing_factor,
            use_adaptive=self.config.use_adaptive_smoothing)
        self.team_classifier = TeamClassifier(device=self.device)
        self.team_selector = InteractiveTeamSelector(headless_names=team_names)

        self.ocr = None  # the jersey-number reader of PLAYER_TRACKING
        if self.mode == ProcessingMode.PLAYER_TRACKING:
            self.ocr = JerseyNumberReader(device=self.device)
        self.tracker = None
        self.use_fused_tracker = False
        if self.mode in _TRACKING_MODES:
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
            tracker = ("fused on the device" if self.use_fused_tracker else
                       type(self.tracker).__name__)
            if teams:
                print(f"TEAM_CLASSIFICATION; tracker: {tracker}")
            else:
                print(f"PLAYER_TRACKING; tracker: {tracker}; jersey-number "
                      f"OCR: {self.ocr.backend or 'none'}")

    def _batch(self) -> int:
        """Frames per device step: `config.resolved_frame_batch`, at most
        DUAL_MAX_BATCH on the dual step."""
        b = self.config.resolved_frame_batch(self.device)
        return min(b, DUAL_MAX_BATCH) if self.use_dual else b

    def _keep(self, det: HostDetections) -> np.ndarray:
        """{player, goalkeeper} above detection_confidence (reference
        main.py:177-195)."""
        keep = (det.classes == PLAYER_CLASS_ID) | (det.classes == GOALKEEPER_CLASS_ID)
        return keep & (det.scores > self.config.detection_confidence)

    def _filter(self, det: HostDetections) -> HostDetections:
        keep = self._keep(det)
        return HostDetections(det.boxes[keep], det.scores[keep], det.classes[keep])

    def _detect_batch(self, frames: np.ndarray, n: int
                      ) -> List[Tuple[HostDetections, Optional[np.ndarray]]]:
        """Each of the batch's n frames' filtered detections and, where the
        detector computes them, their team features (k, 4), through the
        detector's one copy to the host (`fetch_batch`)."""
        with self.timers.stage("detect"):
            host = self.player_detector.fetch_batch(frames)
            rows = [(self._filter(d), None if tf is None else tf[self._keep(d)])
                    for d, _, tf in host.rows()[:n]]
        for d, _ in rows:
            self.timers.count("detections", len(d))
        return rows

    def _batch_keypoints(self, batch: np.ndarray) -> Optional[np.ndarray]:
        """The batch's rink keypoints (B, K, 3) on the host, or None with
        rink keypoints off: the dual step's, after its `detect_batch` on
        this batch, or the separate rink detector's, run here."""
        if self.use_dual:
            return self.player_detector.last_keypoints
        if self.rink_detector is None:
            return None
        with self.timers.stage("keypoints"):
            return self.rink_detector.detect_keypoints_batch(batch)

    def _batches(self, frames: Iterable[np.ndarray], b: int, prefetch: bool):
        """(batch (b, H, W, 3), true count) of the frames; with `prefetch`
        and b > 1 they are read and stacked on a background thread
        (hockey_tpu pipeline.py:406-470)."""
        batches = batched(iter(frames), b, self._stack)
        return prefetched(batches) if prefetch and b > 1 else batches

    def _steps(self, frames: Iterable[np.ndarray], prefetch: bool = False
               ) -> Iterator[Tuple[np.ndarray, Dict]]:
        """(frame, the keyword arguments of `process_frame` for it), batch
        by batch in the mode's route."""
        b = self._batch()
        teams = self.mode == ProcessingMode.TEAM_CLASSIFICATION
        for batch, n in self._batches(frames, b, prefetch):
            if self.use_fused_tracker:
                with self.timers.stage("detect"):
                    out = self.player_detector.detect_track_batch(
                        batch, self.tracker.state)
                    self.tracker.state = out[-1]
                    self.last_track_batch = out
                    rows = unpack_tracked(out)
                kpts = self._batch_keypoints(batch)
                for i in range(n):
                    yield batch[i], dict(
                        pretracked=rows[i][:4], team_feats=rows[i][4],
                        rink_kpts=None if kpts is None else kpts[i])
                continue
            rows = self._detect_batch(batch, n)
            kpts = self._batch_keypoints(batch)
            for i, (det, tf) in enumerate(rows):
                # with frame batch 1 the JAX package detects each frame
                # alone, which drops the fused features, and the classifier
                # samples its crops from the frame instead
                yield batch[i], dict(
                    det=det, team_feats=tf if teams and b > 1 else None,
                    rink_kpts=None if kpts is None else kpts[i])

    def _numeric_steps(self, frames: Iterable[np.ndarray]) -> Iterator[Tuple]:
        """`_tracked_result` of each frame, then its keypoints and
        calibrator stages without drawing (the probe sees the raw frame)."""
        for frame, kw in self._steps(frames):
            rink_kpts = kw.pop("rink_kpts")
            out = self._tracked_result(frame, **kw)
            self._rink(frame, rink_kpts, draw=False)
            yield out

    # ------------------------------------------------------------------
    def detect_frames(self, frames: Iterable[np.ndarray]) -> Iterator[HostDetections]:
        """Frames (H, W, 3) uint8 -> each frame's filtered detections, run
        in device batches of `config.resolved_frame_batch` (at most 32 on
        the dual step)."""
        for batch, n in batched(iter(frames), self._batch(), self._stack):
            for det, _ in self._detect_batch(batch, n):
                yield det

    def track_frames(self, frames: Iterable[np.ndarray]) -> Iterator[Tracked]:
        """Frames (H, W, 3) uint8 -> each frame's (boxes, scores, classes,
        tracker_ids) of the detections that acquired an emittable track, in
        device batches of `config.resolved_frame_batch` (PLAYER_TRACKING).
        The OCR reader reads each frame's due players, without drawing; with
        rink keypoints on, `last_keypoints` and the calibrator's
        `stabilizer.current` are this frame's when it is yielded."""
        if self.mode != ProcessingMode.PLAYER_TRACKING:
            raise ValueError("track_frames needs mode PLAYER_TRACKING")
        for out in self._numeric_steps(frames):
            yield out[:4]

    def classify_frames(self, frames: Iterable[np.ndarray]) -> Iterator[Dict]:
        """Frames (H, W, 3) uint8 -> each frame's `last_frame_result`
        (boxes, scores, classes, tracker_ids, team_ids: players first, then
        goalies with team GOALIE_TEAM_ID), without drawing
        (TEAM_CLASSIFICATION). Fit the classifier first (`fit_teams`);
        unfitted, it takes white_ratio > 0.4 as team 0. With rink keypoints
        on, as `track_frames`."""
        if self.mode != ProcessingMode.TEAM_CLASSIFICATION:
            raise ValueError("classify_frames needs mode TEAM_CLASSIFICATION")
        for _ in self._numeric_steps(frames):
            yield self.last_frame_result

    def _puck_steps(self, frames: Iterable[np.ndarray], prefetch: bool = False
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """(frame, boxes (n, 4), scores (n,)) of each frame: the sliced
        detector over batches of min(frame batch, 16) frames, or frame by
        frame at frame batch 1."""
        pipe = self.puck_pipeline
        b = self.config.resolved_frame_batch(self.device)
        if b == 1:
            for frame in frames:
                with self.timers.stage("detect"):
                    boxes, scores = pipe.detect_frame(frame)
                yield frame, boxes, scores
            return
        for batch, n in self._batches(frames, min(b, PUCK_MAX_BATCH), prefetch):
            with self.timers.stage("detect"):
                boxes, scores, valid = pipe.detect_batch(batch)
            for i in range(n):
                yield batch[i], boxes[i][valid[i]], scores[i][valid[i]]

    def puck_frames(self, frames: Iterable[np.ndarray]) -> Iterator[PuckResult]:
        """Frames (H, W, 3) uint8 -> each frame's PuckResult, the puck
        tracker run on the host in order (PUCK_DETECTION), without drawing."""
        if self.mode != ProcessingMode.PUCK_DETECTION:
            raise ValueError("puck_frames needs mode PUCK_DETECTION")
        for _, boxes, scores in self._puck_steps(frames):
            with self.timers.stage("puck_track"):
                center, detection, _ = self.puck_pipeline.ingest(boxes, scores)
            yield PuckResult(boxes, scores, center, detection)

    # ------------------------------------------------------------------
    @staticmethod
    def _positions(boxes: np.ndarray) -> List[Tuple[float, float]]:
        return [((b[0] + b[2]) / 2.0, (b[1] + b[3]) / 2.0) for b in boxes]

    def fit_teams(self, frames: Iterable[np.ndarray]) -> int:
        """The one-time team fit (reference main.py:197-257) on frames:
        every `initialization_stride`-th frame, at most
        `max_initialization_frames` + 1 of them, is detected; its players go
        through a fresh host ByteTrack (minimum_consecutive_frames=1), and
        the first frame with `min_players_for_selection` tracked players
        goes to the team selector for the names; the classifier is fitted
        on all the players' host crops. Returns the number of crops."""
        cfg = self.config
        crops: List[np.ndarray] = []
        positions: List[Tuple[float, float]] = []
        first = None
        temp_tracker = ByteTrack.from_config(cfg, minimum_consecutive_frames=1)
        sample = itertools.islice(
            iter(frames), 0,
            cfg.initialization_stride * (cfg.max_initialization_frames + 1),
            cfg.initialization_stride)
        for batch, n in batched(sample, self._batch(), self._stack):
            for frame, (det, _) in zip(batch, self._detect_batch(batch, n)):
                pmask = det.classes == PLAYER_CLASS_ID
                pboxes = det.boxes[pmask]
                tb, _, _, tids = temp_tracker.update(
                    pboxes, det.scores[pmask], det.classes[pmask])
                if first is None and len(tids) >= cfg.min_players_for_selection:
                    first = (frame, tb, tids)
                crops.extend(host_crops(frame, pboxes))
                positions.extend(self._positions(pboxes))

        selection = None if first is None else \
            self.team_selector.select_teams(*first)
        if selection:
            self.team_classifier.set_team_names(selection.team_names)
            print(f"Teams set: {selection.team_names[0]} vs "
                  f"{selection.team_names[1]}")
        else:
            print("Team selection cancelled, using default team names")
        self.team_classifier.fit(
            crops, positions=positions,
            frame=None if first is None else first[0],
            detections=None if first is None else first[1:])
        print(f"Classifier fitted on {len(crops)} crops.")
        return len(crops)

    def initialize_team_classifier(self, source_path: str) -> int:
        """`fit_teams` on a video's frames (hockey_tpu pipeline.py:194-233)."""
        print("Initializing team classification...")
        return self.fit_teams(frame_generator(source_path))

    # ------------------------------------------------------------------
    def _detect_frame(self, frame: np.ndarray
                      ) -> Tuple[HostDetections, Optional[np.ndarray]]:
        """One frame detected alone: its filtered detections and, on the
        dual step, its rink keypoints (K, 3) (else None)."""
        with self.timers.stage("detect"):
            det = self._filter(self.player_detector.detect(frame))
        return det, self.player_detector.last_keypoints[0] if self.use_dual else None

    def _rink(self, frame: np.ndarray, rink_kpts: Optional[np.ndarray],
              draw: bool) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The keypoints and rink2d stages of one frame (hockey_tpu
        pipeline.py:330-380): `rink_kpts` (K, 3) (None: the separate rink
        detector's, or no rink at all) -> `last_keypoints`, those above
        `keypoint_confidence_threshold`; with `draw` they are drawn on the
        frame first. With `show_2d_map` the calibrator then takes the frame
        (drawn or raw) and the keypoints, and the homography_* gauges are
        set. Returns (the frame, the stabilised homography or None)."""
        if rink_kpts is None and self.rink_detector is not None:
            rink_kpts = self._batch_keypoints(frame[None])[0]
        if rink_kpts is None:
            return frame, None
        c = self.config
        with self.timers.stage("keypoints"):
            kpts = keypoints_from_array(rink_kpts, c.keypoint_confidence_threshold)
            if kpts:
                if draw:
                    frame = RinkKeypointDetector.visualize_keypoints(
                        frame, kpts, radius=c.keypoint_radius, show_labels=True)
                self.timers.count("keypoints", len(kpts))
        self.last_keypoints = kpts
        if not self.show_2d_map:
            return frame, None
        with self.timers.stage("rink2d"):
            h = self.calibrator.process_frame(frame, kpts)
            q = self.calibrator.last_quality
            if q is not None:
                self.timers.gauge("homography_inlier_ratio", q.inlier_ratio)
                self.timers.gauge("homography_reproj_error_ft",
                                  q.mean_reprojection_error)
                self.timers.gauge("homography_points", q.n_points)
                self.timers.gauge("homography_tier", _TIER_GAUGE.get(
                    self.calibrator.stabilizer.current_tier, 0.0))
        return frame, h

    def _tracked_result(self, frame: np.ndarray,
                        det: Optional[HostDetections] = None,
                        team_feats: Optional[np.ndarray] = None,
                        pretracked: Optional[Tracked] = None):
        """The tracking modes' numbers for one frame: (boxes, scores,
        classes, tids, lookup, labels), also kept as `last_frame_result`.
        `pretracked` rows come from the fused step (else `det` goes through
        the tracker here); `team_feats` (k, 4) align with `pretracked`, or
        with `det` before the tracker."""
        if pretracked is None:
            with self.timers.stage("track"):
                pretracked = self.tracker.update(det.boxes, det.scores, det.classes)
        boxes, scores, classes, tids = pretracked
        self.timers.count("tracks", len(tids))
        pmask = classes == PLAYER_CLASS_ID
        gmask = classes == GOALKEEPER_CLASS_ID

        if self.mode == ProcessingMode.PLAYER_TRACKING:
            labels = []
            for i, tid in enumerate(tids):
                num = self.ocr.get_number(tid) if pmask[i] else None
                tag = f"#{tid}" if num is None else f"#{tid} ({num})"
                labels.append("Goalie " + tag if gmask[i] else tag)
            if pmask.any():
                with self.timers.stage("ocr"):
                    self.ocr.observe(frame, boxes[pmask], tids[pmask])
            lookup = np.where(gmask, GOALIE_TEAM_ID, 0).astype(np.int32)
        else:  # TEAM_CLASSIFICATION, the reference's main path
            player_teams = np.array([], dtype=np.int64)
            if pmask.any():
                with self.timers.stage("teams"):
                    clf = self.team_classifier
                    if team_feats is not None and clf.supports_fused_features():
                        tf = team_feats if det is None \
                            else team_feats[self.tracker.last_indices]
                        player_teams = clf.predict_features(
                            tf[pmask], tracker_ids=tids[pmask])
                    else:
                        player_teams = clf.predict_from_frame(
                            frame, boxes[pmask], tracker_ids=tids[pmask],
                            positions=self._positions(boxes[pmask]))
            # players, then goalies (reference main.py:287-288)
            order = np.concatenate([np.flatnonzero(pmask), np.flatnonzero(gmask)])
            boxes, scores, classes, tids = (boxes[order], scores[order],
                                            classes[order], tids[order])
            lookup = np.concatenate([
                np.asarray(player_teams, np.int32),
                np.full(int(gmask.sum()), GOALIE_TEAM_ID, np.int32)])
            labels = [self.team_classifier.get_team_name(lookup[i])
                      if classes[i] == PLAYER_CLASS_ID else "Goalie"
                      for i in range(len(boxes))]
        self.last_frame_result = {
            "boxes": np.asarray(boxes), "scores": np.asarray(scores),
            "classes": np.asarray(classes), "tracker_ids": np.asarray(tids),
            "team_ids": lookup,
        }
        return boxes, scores, classes, tids, lookup, labels

    def process_frame(self, frame: np.ndarray,
                      det: Optional[HostDetections] = None,
                      team_feats: Optional[np.ndarray] = None,
                      pretracked: Optional[Tracked] = None,
                      rink_kpts: Optional[np.ndarray] = None) -> np.ndarray:
        """Draw one frame. PLAYER_DETECTION: `det`'s boxes (the frame is
        detected here without it) with Player and Goalie labels. The
        tracking modes: `_tracked_result`'s rows, smoothed per tracker id;
        PLAYER_TRACKING labels '#id', '#id (number)' or 'Goalie #id',
        TEAM_CLASSIFICATION the team's name or 'Goalie', coloured by team;
        with rink keypoints on, the keypoints (`rink_kpts`, this frame's
        row of the batch's) drawn under the boxes and, with `show_2d_map`,
        the map in the bottom-right corner. PUCK_DETECTION: the puck
        pipeline on the frame alone."""
        if self.mode == ProcessingMode.PUCK_DETECTION:
            return self.puck_pipeline.process_frame(frame)
        if det is None and pretracked is None:
            det, rink_kpts = self._detect_frame(frame)
        if self.mode == ProcessingMode.PLAYER_DETECTION:
            with self.timers.stage("annotate"):
                lookup = np.where(det.classes == GOALKEEPER_CLASS_ID,
                                  GOALIE_TEAM_ID, 0).astype(np.int32)
                labels = ["Goalie" if c == GOALKEEPER_CLASS_ID else "Player"
                          for c in det.classes]
                out = self.box_annotator.annotate(frame.copy(), det.boxes,
                                                  lookup)
                return self.label_annotator.annotate(out, det.boxes, labels, lookup)

        boxes, scores, _, tids, lookup, labels = self._tracked_result(
            frame, det, team_feats, pretracked)
        # the keypoints are drawn on the frame before the calibrator's probe
        # reads it, as in the JAX package (hockey_tpu pipeline.py:345-369)
        frame, h = self._rink(frame, rink_kpts, draw=True)
        with self.timers.stage("annotate"):
            out = self.smooth_annotator.annotate(frame.copy(), boxes, tids,
                                                 scores, lookup)
            out = self.label_annotator.annotate(out, boxes, labels, lookup)
        if h is not None:
            with self.timers.stage("rink2d"):
                rink_map = self.rink_renderer.render(
                    h, bottom_center_anchors(boxes), lookup)
                out = self.rink_renderer.overlay(out, rink_map)
        return out

    def process_video(self, source_path: str, start_frame: int = 0,
                      skip_init: bool = False,
                      limit: Optional[int] = None) -> Iterator[np.ndarray]:
        """Annotated frames of a video from `start_frame`, at most `limit`:
        in TEAM_CLASSIFICATION the one-time team fit first (unless
        `skip_init`, as when a run resumes from a saved state,
        core/session.py), then the mode's device step in batches, their
        frames decoded on a background thread, and drawing frame by frame
        in order (hockey_tpu pipeline.py:388-470)."""
        if self.mode == ProcessingMode.TEAM_CLASSIFICATION and not skip_init:
            self.initialize_team_classifier(source_path)
        frames = frame_generator(source_path, start=start_frame, limit=limit)
        if self.mode == ProcessingMode.PUCK_DETECTION:
            for frame, boxes, scores in self._puck_steps(frames, prefetch=True):
                with self.timers.stage("annotate"):
                    out = self.puck_pipeline.annotate(frame, boxes, scores)
                yield out
            return
        if self.mode == ProcessingMode.PLAYER_DETECTION:
            for batch, n in self._batches(frames, self._batch(), prefetch=True):
                for i, (det, _) in enumerate(self._detect_batch(batch, n)):
                    yield self.process_frame(batch[i], det)
            return
        for frame, kw in self._steps(frames, prefetch=True):
            yield self.process_frame(frame, **kw)


def unpack_tracked(out) -> List[Tuple]:
    """The fused step's output -> per-frame host rows (boxes, scores,
    classes, tids, team features (k, 4) or None) of the detections that
    acquired an emittable track id, from its `packed` tensor in one copy
    (`fetch`) (hockey_tpu pipeline.py:476-491)."""
    return [(d.boxes, d.scores, d.classes, tids, tf)
            for d, tids, tf in fetch(out[3]).rows()]


def process_video_with_display(processor: VideoProcessor, source_path: str,
                               target_path: Optional[str] = None,
                               display: bool = True,
                               limit: Optional[int] = None) -> int:
    """Write (and optionally show) the annotated video; returns the number
    of frames written (hockey_tpu pipeline.py process_video_with_display)."""
    import cv2

    n = 0
    sink = None
    try:
        if target_path:
            sink = VideoSinkWriter(target_path,
                                   VideoInfo.from_video_path(source_path))
        for frame in processor.process_video(source_path, limit=limit):
            if sink is not None:
                sink.write(frame)
            n += 1
            if display:
                cv2.imshow("Hockey Vision", frame)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
    finally:
        if sink is not None:
            sink.close()
        if display:
            cv2.destroyAllWindows()
    return n


class VideoSinkWriter:
    """An open mp4 writer: `write` each frame, then `close`, which
    finishes the file (hockey_tpu pipeline.py VideoSinkWriter)."""

    def __init__(self, path: str, info: VideoInfo):
        self._sink = VideoSink(path, info).__enter__()

    def write(self, frame: np.ndarray) -> None:
        self._sink.write_frame(frame)

    def close(self) -> None:
        self._sink.__exit__()
