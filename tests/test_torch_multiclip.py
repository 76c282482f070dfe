"""The port's multi-clip mode (hockey_tpu_torch/multiclip.py), mirroring
tests/test_multiclip.py on the CPU, plus:

- `run_frames` gives each clip the tracker ids and boxes of the JAX
  MultiClipProcessor on the same stub detections, exactly;
- with the real detector (the shipped YOLOv8x, f32, imgsz 256), each
  clip's ids and team ids equal that clip run alone through a
  single-clip VideoProcessor with the same detector and the same batch
  size (B = K = 2), exactly, and its boxes within 1e-3 px, in
  PLAYER_TRACKING and TEAM_CLASSIFICATION. The boxes are not bit-equal:
  a batch holds other frames in the two runs, and oneDNN's convolutions
  can round a sample apart by its batch's company (measured: one
  coordinate of 28 off by 3.8e-6 px).
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from hockey_tpu.core.config import ProcessingMode as JaxMode  # noqa: E402
from hockey_tpu.multiclip import MultiClipProcessor as JaxMultiClip  # noqa: E402
from hockey_tpu.train.scenes import render_scene_sequence  # noqa: E402
from hockey_tpu_torch.core.config import Config, ProcessingMode  # noqa: E402
from hockey_tpu_torch.models.detector import Detector, fetch, pack  # noqa: E402
from hockey_tpu_torch.multiclip import MultiClipProcessor  # noqa: E402
from hockey_tpu_torch.pipeline import VideoProcessor  # noqa: E402
from tests.test_multiclip import MultiStubDetector  # noqa: E402
from tests.test_pipeline import H, W, gt_detections, make_frame, small_config  # noqa: E402
from tests.test_torch_session import (  # noqa: E402, F401
    one_torch_thread,
    padded,
    port_config,
)


class PortMultiStubDetector:
    """Every row of a batch gets the canned detections of call `calls`."""

    def __init__(self):
        self.calls = 0

    def detect_batch(self, frames):
        self.calls += 1
        return padded([gt_detections(self.calls - 1)] * len(frames))

    def fetch_batch(self, frames):
        return fetch(pack(self.detect_batch(frames)))


@pytest.fixture
def clips(tmp_path):
    paths = []
    for k, n_frames in enumerate((12, 8)):  # different lengths
        p = str(tmp_path / f"clip{k}.mp4")
        w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 30, (W, H))
        for i in range(n_frames):
            w.write(make_frame(i))
        w.release()
        paths.append(p)
    return paths


@pytest.fixture(autouse=True)
def headless_env(monkeypatch):
    monkeypatch.setenv("HOCKEY_TPU_HEADLESS", "1")


def make_mp(sources=(), stub=None, **kw):
    return MultiClipProcessor(sources, config=port_config(),
                              mode=ProcessingMode.PLAYER_TRACKING,
                              team_names=("A", "B"),
                              player_detector=stub or PortMultiStubDetector(),
                              device="cpu", **kw)


def test_lockstep_processing_and_lengths(clips, tmp_path):
    targets = [str(tmp_path / "out0.mp4"), str(tmp_path / "out1.mp4")]
    assert make_mp(clips).run(targets) == [12, 8]
    for t, want in zip(targets, (12, 8)):
        cap = cv2.VideoCapture(t)
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == want
        cap.release()


def test_one_device_call_per_frame_row(clips):
    stub = PortMultiStubDetector()
    assert make_mp(clips, stub).run(limit_frames=5) == [5, 5]
    assert stub.calls == 5


def test_per_clip_tracker_isolation(clips):
    mp = make_mp(clips)
    mp.run(limit_frames=4)
    ids0 = {t.track_id for t in mp.processors[0].tracker.tracks}
    ids1 = {t.track_id for t in mp.processors[1].tracker.tracks}
    assert ids0 and ids0 == ids1  # separate id spaces, both from 1
    assert mp.processors[0].tracker is not mp.processors[1].tracker
    assert all(p.player_detector is mp.detector for p in mp.processors)


def test_mismatched_resolution_rejected(clips, tmp_path):
    p = str(tmp_path / "odd.mp4")
    w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 30, (320, 240))
    for _ in range(4):
        w.write(np.zeros((240, 320, 3), np.uint8))
    w.release()
    with pytest.raises(ValueError):
        make_mp(clips + [p])
    mp = make_mp(frame_hw=(H, W), n_clips=2)
    with pytest.raises(ValueError, match="frame"):
        list(mp.run_frames([[make_frame(0)], [np.zeros((240, 320, 3), np.uint8)]]))
    with pytest.raises(ValueError):
        make_mp()  # neither sources nor n_clips and frame_hw


def test_run_frames_matches_jax(clips):
    """The frames entry on the decoded clips against the JAX
    MultiClipProcessor's run on the files, same canned detections."""
    jmp = JaxMultiClip(clips, config=small_config(), mode=JaxMode.PLAYER_TRACKING,
                       team_names=("A", "B"), player_detector=MultiStubDetector())
    want = {0: [], 1: []}
    for i, p in enumerate(jmp.processors):
        def record(frame, det, _p=p, _i=i, _draw=p.process_frame):
            out = _draw(frame, det)
            want[_i].append(dict(_p.last_frame_result))
            return out
        p.process_frame = record
    assert jmp.run() == [12, 8]

    decoded = []
    for path in clips:
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        decoded.append(frames)
    mp = make_mp(frame_hw=(H, W), n_clips=2)
    got = {0: [], 1: []}
    for i, r in mp.run_frames(decoded):
        got[i].append(r)
    for i in (0, 1):
        assert len(got[i]) == len(want[i]) == (12, 8)[i]
        for g, w in zip(got[i], want[i]):
            np.testing.assert_array_equal(g["tracker_ids"], w["tracker_ids"])
            np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def scene_clips():
    """Two 6-frame clips of a rendered scene at 320, seeds 3 and 4."""
    return [np.stack(render_scene_sequence(np.random.default_rng(s), 320,
                                           n_frames=6)[0]) for s in (3, 4)]


@pytest.fixture(scope="module")
def detector():
    return Detector("hockey-player-detection", Config(), frame_hw=(320, 320),
                    imgsz=256, device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("mode", [ProcessingMode.PLAYER_TRACKING,
                                  ProcessingMode.TEAM_CLASSIFICATION])
def test_each_clip_equals_a_single_clip_run(scene_clips, detector, mode):
    cfg = Config(frame_batch=2, detection_imgsz=256)
    mp = MultiClipProcessor(config=cfg, mode=mode, player_detector=detector,
                            device="cpu", frame_hw=(320, 320), n_clips=2,
                            team_names=("A", "B"))
    got = {0: [], 1: []}
    for i, r in mp.run_frames(scene_clips):
        got[i].append({k: v.copy() for k, v in r.items()})
    for i, clip in enumerate(scene_clips):
        vp = VideoProcessor(cfg, device="cpu", mode=mode, frame_hw=(320, 320),
                            player_detector=detector, team_names=("A", "B"))
        if mode == ProcessingMode.TEAM_CLASSIFICATION:
            vp.fit_teams(iter(clip))
            want = [dict(r) for r in vp.classify_frames(iter(clip))]
        else:
            want = [dict(vp.last_frame_result) for _ in vp.track_frames(iter(clip))]
        assert len(got[i]) == len(want) == len(clip)
        assert sum(len(w["tracker_ids"]) for w in want) >= 6
        for g, w in zip(got[i], want):
            for k in ("tracker_ids", "team_ids", "classes"):
                np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-3)
