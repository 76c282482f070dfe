"""Run checkpoint and resume in the port (hockey_tpu_torch/core/session.py),
mirroring tests/test_session.py, on the CPU with a stub detector, plus:

- the team state of each of the five strategies survives a save and a
  load: the same team ids afterwards, exactly;
- a state file written by the JAX package loads in the port: its host
  ByteTrack tracks and segmentation fit, and its DeviceByteTrack
  `TrackState` (the same fields in the same order in both packages); the
  port then gives the JAX processor's tracker ids, exactly;
- a save and resume through `process_video` gives the ids of an
  uninterrupted run, exactly.
"""

import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from hockey_tpu.core.config import Config as JaxConfig  # noqa: E402
from hockey_tpu.core.config import ProcessingMode as JaxMode  # noqa: E402
from hockey_tpu.core.session import save_run_state as jax_save  # noqa: E402
from hockey_tpu.pipeline import VideoProcessor as JaxVideoProcessor  # noqa: E402
from hockey_tpu_torch.core.config import Config, ProcessingMode  # noqa: E402
from hockey_tpu_torch.core.session import load_run_state, save_run_state  # noqa: E402
from hockey_tpu_torch.models.detector import HostDetections, fetch, pack  # noqa: E402
from hockey_tpu_torch.ops.nms import Detections  # noqa: E402
from hockey_tpu_torch.pipeline import VideoProcessor  # noqa: E402
from hockey_tpu_torch.teams.facade import TeamClassifier  # noqa: E402
from hockey_tpu_torch.tracking.device_tracker import DeviceByteTrack  # noqa: E402
from tests.test_pipeline import (  # noqa: E402
    H,
    W,
    StubDetector,
    gt_detections,
    make_frame,
    small_config,
)
from tests.test_teams import RED, WHITE, make_crop  # noqa: E402


def padded(rows, max_det: int = 16) -> Detections:
    """[(boxes, scores, classes)] -> the port's padded Detections."""
    n = len(rows)
    boxes = torch.zeros(n, max_det, 4)
    scores = torch.full((n, max_det), -1.0)
    classes = torch.full((n, max_det), -1, dtype=torch.int32)
    valid = torch.zeros(n, max_det, dtype=torch.bool)
    for i, (b, s, c) in enumerate(rows):
        boxes[i, :len(b)] = torch.from_numpy(b)
        scores[i, :len(b)] = torch.from_numpy(s)
        classes[i, :len(b)] = torch.from_numpy(c)
        valid[i, :len(b)] = True
    return Detections(boxes, scores, classes, valid)


class PortStubDetector:
    """tests/test_pipeline.py's StubDetector for the port: the canned
    detections of frame `frame_idx`, as torch tensors."""

    def __init__(self):
        self.frame_idx = 0

    def _next(self):
        self.frame_idx += 1
        return gt_detections(self.frame_idx - 1)

    def detect(self, frame):
        return HostDetections(*self._next())

    def detect_batch(self, frames):
        return padded([self._next() for _ in range(len(frames))])

    def fetch_batch(self, frames):
        return fetch(pack(self.detect_batch(frames)))


def port_config(**kw) -> Config:
    """tests/test_pipeline.py's small_config for the port."""
    return Config(**{**{f: getattr(small_config(), f) for f in
                        ("detection_imgsz", "initialization_stride",
                         "max_initialization_frames")}, **kw})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process: the CPU tests run in parallel
    workers, where many small ops, each split over every core, wait on
    descheduled threads (measured under load: 33 s on one thread against
    160 s on two for two of these tests)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def headless_env(monkeypatch):
    monkeypatch.setenv("HOCKEY_TPU_HEADLESS", "1")
    monkeypatch.setitem(sys.modules, "transformers", None)


def make_proc(mode=ProcessingMode.PLAYER_TRACKING, **cfg):
    return VideoProcessor(port_config(**cfg), device="cpu", mode=mode,
                          frame_hw=(H, W), player_detector=PortStubDetector(),
                          team_names=("A", "B"))


def test_tracker_ids_survive_resume(tmp_path):
    p1 = make_proc()
    for i in range(6):
        p1.process_frame(make_frame(i))
    ids_before = sorted(t.track_id for t in p1.tracker.tracks)
    state = str(tmp_path / "run.state")
    save_run_state(state, p1, frame_idx=6)

    p2 = make_proc()
    assert load_run_state(state, p2) == 6
    assert sorted(t.track_id for t in p2.tracker.tracks) == ids_before
    p2.player_detector.frame_idx = 6
    p2.process_frame(make_frame(6))
    assert sorted(t.track_id for t in p2.tracker.tracks
                  if t.time_since_update == 0) == ids_before


def test_version_check(tmp_path):
    bad = str(tmp_path / "bad.state")
    np.savez(bad, manifest=np.frombuffer(b'{"version": 999}', np.uint8))
    with pytest.raises(ValueError, match="version"):
        load_run_state(bad + ".npz", make_proc())


def _crops(rng, n):
    return ([make_crop(WHITE, noise=8, rng=rng) for _ in range(n)]
            + [make_crop(RED, noise=8, rng=rng) for _ in range(n)])


FLAGS = {
    "segmentation": {},
    "interactive": dict(use_segmentation=False),
    "robust": dict(use_segmentation=False, use_interactive=False),
    "hybrid": dict(use_segmentation=False, use_interactive=False, use_robust=False),
    "simple": dict(use_segmentation=False, use_interactive=False, use_robust=False,
                   use_hybrid=False),
}


@pytest.mark.parametrize("strategy", sorted(FLAGS))
def test_team_state_of_each_strategy_round_trips(tmp_path, strategy):
    """Fit, predict a few frames (vote histories), save; a fresh processor
    restores the strategy and predicts the next frames as the original."""
    rng = np.random.default_rng(0)
    p1 = make_proc(ProcessingMode.TEAM_CLASSIFICATION)
    p1.team_classifier = TeamClassifier(device="cpu", **FLAGS[strategy])
    tc = p1.team_classifier
    crops = _crops(rng, 12)
    if strategy == "interactive":
        assert tc._impl.initialize_from_examples(crops[:3], crops[12:15])
    else:
        tc.fit(crops, positions=[(10.0 * i, 50.0) for i in range(24)])
    assert tc.active_strategy == strategy
    tc.set_team_names({0: "TOR", 1: "DET"})
    frames = [_crops(rng, 2) for _ in range(6)]
    tids = np.arange(1, 5)
    pos = [(10.0, 5.0), (30.0, 5.0), (50.0, 5.0), (70.0, 5.0)]
    for c in frames[:3]:
        tc.predict(c, tids, pos)
    state = str(tmp_path / "run.state")
    save_run_state(state, p1, frame_idx=42)

    p2 = make_proc(ProcessingMode.TEAM_CLASSIFICATION)
    assert load_run_state(state, p2) == 42
    assert p2.team_classifier.active_strategy == strategy
    assert p2.team_classifier.get_team_name(1) == "DET"
    for c in frames[3:]:
        want = tc.predict(c, tids, pos)
        np.testing.assert_array_equal(p2.team_classifier.predict(c, tids, pos), want)
        assert list(want) == [0, 0, 1, 1]


def test_jax_state_file_loads(tmp_path):
    """A JAX processor's host ByteTrack and segmentation fit, saved by the
    JAX package, restored into the port: the same tracks, the same fit,
    and the same ids and teams on the frames after."""
    rng = np.random.default_rng(1)
    jp = JaxVideoProcessor(config=small_config(), mode=JaxMode.TEAM_CLASSIFICATION,
                           frame_hw=(H, W), player_detector=StubDetector(),
                           team_names=("A", "B"))
    jp.team_classifier.fit(_crops(rng, 10))
    jp.team_classifier.set_team_names({0: "TOR", 1: "DET"})
    for i in range(6):
        jp.process_frame(make_frame(i))
    state = str(tmp_path / "jax.state")
    jax_save(state, jp, frame_idx=6)

    p = make_proc(ProcessingMode.TEAM_CLASSIFICATION)
    assert load_run_state(state, p) == 6
    assert p.team_classifier.get_team_name(0) == "TOR"
    np.testing.assert_array_equal(p.team_classifier._impl.kmeans.cluster_centers_,
                                  jp.team_classifier._impl.kmeans.cluster_centers_)
    assert [t.track_id for t in p.tracker.tracks] == \
        [t.track_id for t in jp.tracker.tracks]
    p.player_detector.frame_idx = jp.player_detector.frame_idx = 6
    for i in range(6, 10):
        p.process_frame(make_frame(i))
        jp.process_frame(make_frame(i))
        for k in ("tracker_ids", "team_ids"):
            np.testing.assert_array_equal(p.last_frame_result[k],
                                          jp.last_frame_result[k])


def test_jax_device_tracker_state_loads(tmp_path):
    """The JAX DeviceByteTrack's TrackState arrays load into the port's
    DeviceByteTrack (same fields, same order): ids equal on the frames
    after."""
    jp = JaxVideoProcessor(config=JaxConfig(**{**vars(small_config()),
                                               "use_device_tracker": True}),
                           mode=JaxMode.PLAYER_TRACKING, frame_hw=(H, W),
                           player_detector=StubDetector(), team_names=("A", "B"))
    p = make_proc(use_device_tracker=True)
    assert isinstance(p.tracker, DeviceByteTrack) and not p.use_fused_tracker
    for i in range(5):
        jp.process_frame(make_frame(i))
    state = str(tmp_path / "jax_device.state")
    jax_save(state, jp, frame_idx=5)
    assert load_run_state(state, p) == 5
    assert p.tracker.state.track_id.dtype == torch.int32
    p.player_detector.frame_idx = jp.player_detector.frame_idx = 5
    for i in range(5, 9):
        p.process_frame(make_frame(i))
        jp.process_frame(make_frame(i))
        np.testing.assert_array_equal(p.last_frame_result["tracker_ids"],
                                      jp.last_frame_result["tracker_ids"])
    with pytest.raises(ValueError, match="tracker"):
        load_run_state(state, make_proc())  # device state, host tracker


def test_resume_through_process_video_matches_uninterrupted(tmp_path):
    clip = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 30, (W, H))
    for i in range(16):
        w.write(make_frame(i))
    w.release()

    def run(p, **kw):
        out = []
        for _ in p.process_video(clip, **kw):
            out.append({k: v.copy() for k, v in p.last_frame_result.items()})
        return out

    full = run(make_proc(ProcessingMode.TEAM_CLASSIFICATION))
    p1 = make_proc(ProcessingMode.TEAM_CLASSIFICATION)
    first = run(p1, limit=9)
    state = str(tmp_path / "run.state")
    save_run_state(state, p1, frame_idx=9)
    p2 = make_proc(ProcessingMode.TEAM_CLASSIFICATION)
    p2.player_detector.frame_idx = p1.player_detector.frame_idx
    rest = run(p2, start_frame=load_run_state(state, p2), skip_init=True)
    assert len(first) == 9 and len(first) + len(rest) == len(full) == 16
    for got, want in zip(first + rest, full):
        for k in ("tracker_ids", "team_ids", "boxes"):
            np.testing.assert_array_equal(got[k], want[k])
